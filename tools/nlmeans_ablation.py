"""Where NL-means' kernel spends its time on the GPU.

    python3 tools/nlmeans_ablation.py [--reps N] [--baseline CSRC_DIR]

Builds ``csrc/nlmeans.cu`` and edited copies of it under
``build/nlmeans_ablation/`` (one nvcc each, all started together), and
times each by CUDA events at the shapes of ``chip_smoke.py``'s
``NLM_CASES``: the Lab joint pass on the 32 x 544^2 tile chunk, the 4 x
544^2 chunk of a 1024x768 request, a whole 768x576 image, a ragged 2 x 37
x 23 batch and a 9x11 image, and one field over three channels with sigma
6 on a 96x80 float image. ``--baseline`` builds another ``csrc``'s
``nlmeans.cu`` (e.g. the parent commit's ``git archive`` unpacked under
``outputs/``; the C entry is the same) and times it in turns with
this one (baseline, kernel, kernel, baseline) at every shape.

The copies take each lever of the design out: one column a lane (the
7-wide row sums by four shuffles a column, 26 outputs a warp); the centre
pixels from shared memory, at 8 and at 16 rows a warp; the exact weight
(the area division by ``div_area``, the clamp, the product with -1/h^2,
``expf``, num without FMA); no split of the search rows between a
cluster's blocks. To see what binds: without the row-sum shuffles (each
lane's own sums stand in), without the shifted pixels' shared-memory
loads (a centre register stands in), without the exps (w = 1 + the
exponent) and at one search offset instead of 441 (the patch copy and
the stores). Prints each build's registers and spills (ptxas), the SASS
instruction mix of the Lab instantiation (``cuobjdump``), and the SM
clock and power draw while the kernel runs at each shape. The edited
copies but the exact-weight, centre and split ones compute wrong
outputs: they are timed, not checked. Needs a CUDA GPU (~2 min with the
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
# The exact weight: the C entry's -1/h^2 and 2 sigma^2 as given, the area
# division by div_area (the IEEE quotient), the clamp, the product, expf.
EXACT = r'''
__device__ __forceinline__ float div_area(float d, float a, float r) {
  const float q = __fmul_rn(d, r);
  return __fmaf_rn(__fmaf_rn(-q, a, d), r, q);
}

template <int MODE, int C>
__device__ __forceinline__ float exact_weight(float d, int f,
                                              const Params& p) {
  const float area = MODE == LAB ? (f == 0 ? 49.f : 98.f) : 49.f * C;
  const float dist = div_area(d, area, 1.f / area);
  const float t = MODE == LAB ? dist : fmaxf(__fsub_rn(dist, p.s2), 0.f);
  return expf(__fmul_rn(t, f == 0 ? p.n0 : p.n1));
}

__device__ __forceinline__ void row_sums('''
# Row sums with one column a lane (four shuffles a column): whole for
# lanes 3 .. 28.
ROW_SUMS1 = r'''__device__ __forceinline__ void row_sums(const float (&v)[CPL],
                                         float (&out)[CPL]) {
  const float a = v[0] + __shfl_down_sync(FULL, v[0], 1);
  const float b = a + __shfl_up_sync(FULL, a, 2);
  out[0] = (b + __shfl_up_sync(FULL, v[0], 3)) + __shfl_down_sync(FULL, a, 2);
}
'''
WEIGHT = '''            w[f][j] = MODE == LAB
                          ? ex2(sum[j] * (f == 0 ? p.k0 : p.k1))
                          : ex2(fminf(fmaf(sum[j], p.k0, p.b0), 0.f));'''
NUM = '''            num[r][j][c] = fmaf(w[(MODE == LAB && c > 0) ? NF - 1 : 0][j],
                                val[r][j][c], num[r][j][c]);'''
VARIANTS = {
    "kernel": [],
    "one column a lane": [
        ("constexpr int CPL = 2;", "constexpr int CPL = 1;"),
        ('static_assert(CPL == 2, "row_sums takes two columns a lane");', ""),
        (re.compile(r"__device__ __forceinline__ void row_sums\(.*?\n}\n",
                    re.S), ROW_SUMS1)],
    "centre from shared": [("constexpr bool CTR_REGS = true;",
                            "constexpr bool CTR_REGS = false;")],
    "16 rows, centre from shared": [
        ("constexpr bool CTR_REGS = true;", "constexpr bool CTR_REGS = false;"),
        ("constexpr int RH = 8;", "constexpr int RH = 16;")],
    "exact weights": [
        ("__device__ __forceinline__ void row_sums(", EXACT),
        ("  float b0;           // ONE: -2 sigma^2 area k0, the clamp's offset\n",
         "  float b0;\n  float n0, n1, s2;\n"),
        ("  p.b0 = (float)(", "  p.n0 = neg_inv0;\n  p.n1 = neg_inv1;\n"
         "  p.s2 = two_sigma2;\n  p.b0 = (float)("),
        (WEIGHT, "            w[f][j] = exact_weight<MODE, C>(sum[j], f, p);"),
        (NUM, "            num[r][j][c] = __fadd_rn(num[r][j][c], __fmul_rn("
              "w[(MODE == LAB && c > 0) ? NF - 1 : 0][j], val[r][j][c]));")],
    "no split": [("p.split = choose_split(", "p.split = 1 + 0 * choose_split(")],
    "no row-sum shuffles": [(re.compile(
        r"__shfl_(?:up|down)_sync\(FULL, (\w+(?:\[\d\])?), \d\)"), r"\1")],
    "no shifted loads": [("load_px<C>(tile, at[j] + i * EXT_W, s);",
                          "for (int c = 0; c < C; ++c) s[c] = ctr[(i + 1) % "
                          "(ctr_regs ? DR : 1)][j][c] + float(dx);")],
    "no exps": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                 "y = 1.f + x;")],
    "one offset": [("for (int dy = dy0; dy < dy1; ++dy)",
                    "for (int dy = dy0; dy < dy0 + 1; ++dy)"),
                   ("for (int dx = 0; dx < SRCH; ++dx)",
                    "for (int dx = 0; dx < 1; ++dx)")],
}
# (label, kind, (B, H, W), reps): chip_smoke.py's NLM_CASES.
CASES = [("32 x 544^2 chunk", "Lab", (32, 544, 544), 5),
         ("4 x 544^2 (1024x768 request)", "Lab", (4, 544, 544), 20),
         ("768x576 image", "Lab", (1, 576, 768), 20),
         ("2 x 37 x 23 batch", "Lab", (2, 37, 23), 50),
         ("9x11 image", "Lab", (1, 9, 11), 50),
         ("96x80 one field, sigma 6", "one", (1, 96, 80), 50)]


def case_input(torch, np, kind: str, shape, seed: int):
    """Seeded noisy images (flat 16 x 16 patches, noise std 12) as the
    linear Lab the joint pass takes, or as a float image."""
    from neural_enhanced_super_resolution_torch.ops.color import rgb_to_lab
    rng = np.random.default_rng(seed)
    n, h, w = shape
    flat = rng.integers(0, 256, (n, h // 16 + 1, w // 16 + 1, 3))
    img = np.kron(flat, np.ones((1, 16, 16, 1)))[:, :h, :w]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    if kind == "one":
        return torch.from_numpy(img.astype(np.float32)).to("cuda")
    x = torch.from_numpy(img.astype(np.uint8)).to("cuda")
    return rgb_to_lab(x.flip(-1), srgb=False).float().contiguous()


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills of each nlmeans_kernel<MODE, C> in a ptxas
    report."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*nlmeans_kernelILi(\d)"
                      r"ELi(\d)E", line)
        if not m:
            continue
        tail = " ".join(lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", tail)
        regs = re.search(r"Used (\d+) registers", tail)
        out.append(f"<{'LAB' if m[1] == '1' else 'ONE'}, {m[2]}> "
                   f"{regs[1] if regs else '?'} registers, "
                   f"{spill[1] if spill else '?'} / "
                   f"{spill[2] if spill else '?'} bytes spilled")
    return out


def sass_mix(so: str, cuobjdump: str) -> str:
    """The SASS of nlmeans_kernel<1, 3> (the Lab pass): its instructions
    by opcode, and those of the offsets' loop (the innermost loop of over
    200 instructions; the kernel takes two offsets a trip)."""
    sass = subprocess.run([cuobjdump, "--dump-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        if "nlmeans_kernelILi1ELi3E" not in func.split(None, 1)[0]:
            continue
        ins = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z0-9_.]+)([^;]*);", func)]
        loops = [[op for addr, op, _ in ins if start <= addr <= end]
                 for end, op, rest in ins if op == "BRA"
                 and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and (start := int(m[1], 16)) < end]
        body = min((b for b in loops if len(b) > 200), key=len, default=[])
        mix = collections.Counter(op for _, op, _ in ins).most_common(16)
        return (f"{len(ins)} instructions, {mix}; the offsets' loop "
                f"{len(body)}: {collections.Counter(body).most_common(16)}")
    raise SystemExit("nlmeans_kernel<1, 3> not in the SASS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1,
                    help="multiplies each case's launches a timing")
    ap.add_argument("--baseline", help="another csrc directory to time")
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
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    jobs = {name: prepare(OUT, name.replace(" ", "_").replace(",", ""),
                          SOURCE, edits, ptxas=True)
            for name, edits in VARIANTS.items()}
    if args.baseline:
        jobs["baseline"] = prepare(OUT, "baseline", SOURCE,
                                   csrc=os.path.abspath(args.baseline),
                                   ptxas=True)
    libs = {}
    for name, (so, _, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        print(f"{name}: " + "; ".join(ptxas_lines(log)), flush=True)
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nesr_nl_means.argtypes = [vp] * 2 + [ci] * 5 + [cf] * 3 + [vp]
        lib.nesr_nl_means.restype = ci
        libs[name] = lib
    cuobjdump = _build.cuda_tool("cuobjdump")
    for name in ("kernel", "baseline"):
        if name in jobs:
            print(f"{name} SASS, nlmeans_kernel<1, 3>: "
                  + sass_mix(jobs[name][0], cuobjdump), flush=True)

    for label, kind, shape, reps in CASES:
        x = case_input(torch, np, kind, shape, sum(shape))
        out = torch.empty_like(x)
        fields, sigma = ((((0,), 5.0), ((1, 2), 5.0)), 0.0) if kind == "Lab" \
            else ((((0, 1, 2), 9.0),), 6.0)
        mode, neg0, neg1 = _layout(x, fields, sigma, 7, 21)
        two_sigma2 = float(np.float32(2.0) * np.float32(sigma) ** 2)
        b, h, w, c = x.shape

        def run(lib):
            def fn():
                _build.check("nesr_nl_means", lib.nesr_nl_means(
                    x.data_ptr(), out.data_ptr(), b, h, w, c, mode, neg0,
                    neg1, two_sigma2, _build.stream_ptr()))
            return fn

        n = reps * args.reps
        times = collections.defaultdict(list)
        clocks = subprocess.Popen(   # for ~1 s of the kernel
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        ms = timed(torch, run(libs["kernel"]), n)
        timed(torch, run(libs["kernel"]), max(n, int(1000 / ms)))
        clocks.terminate()
        samples = clocks.communicate()[0].split("\n")
        print(f"{label}: SM clock and power while the kernel runs "
              f"(nvidia-smi every 200 ms): {[x for x in samples if x]}",
              flush=True)
        if args.baseline:
            for name in ("baseline", "kernel", "kernel", "baseline"):
                times[name].append(timed(torch, run(libs[name]), n))
            new, old = times["kernel"], times["baseline"]
            print(f"{label} {tuple(x.shape)} on {card}, in turns: baseline "
                  f"{old[0]:.4f}, kernel {new[0]:.4f}, {new[1]:.4f}, baseline"
                  f" {old[1]:.4f} ms; baseline / kernel "
                  f"{min(old) / max(new):.3f}-{max(old) / min(new):.3f}",
                  flush=True)
        for name in list(VARIANTS) + ["kernel"]:
            times[name].append(timed(torch, run(libs[name]), n))
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
