"""Where K1's time goes: the kernel against copies of itself with one part
taken out, on one CUDA GPU.

    python3 tools/k1_ablation.py [--baseline CSRC_DIR]

Copies ``csrc/`` into ``build/k1_ablation/<variant>/``, edits each copy's
``conv3x3.cu`` and its mainloop ``conv3x3_body.cuh`` as listed in VARIANTS
(the edits are textual; a variant whose text no longer matches fails
loudly), builds each copy with its own nvcc (all at once), and times
every variant at the fused trunk's w0, w2 and w4 and at conv_body on the
4 x 268 x 268 tile batch, with CUDA events over REPS launches after a
warm-up, in the order base, variants, base.
The variants compute wrong outputs on purpose; only their times mean
anything. One more copy stamps the GPU's clock (thread 0 of each block)
at each phase of a block, and the median phase times are printed for
each shape. With ``--baseline``, another ``csrc/`` (e.g. a ``git
archive`` of an earlier commit) is built unedited and timed first and last,
beside this one's, and both builds' registers and spills are printed.
Prints the card (name, power limit) and one line per variant and shape.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

from ablation_build import ROOT, prepare, timed

OUT = os.path.join(ROOT, "build", "k1_ablation")
REPS = 20
# (label, Cin, Cout) at the tile batch.
SHAPES = [("w0 64->192", 64, 192), ("w2 32->128", 32, 128),
          ("w4 32->64", 32, 64), ("conv_body 64->64", 64, 64)]
KEEP_WIDTHS = (64, 96, 128)   # instantiations the shapes need
# variant: [(old text, new text), ...] applied to conv3x3.cu and
# conv3x3_body.cuh, each to every place the old text appears
VARIANTS = {
    "base": [],
    # the output's global stores skipped (the tile still goes through
    # shared memory, so the MMAs stay live)
    "no_store": [("        if (gy < p.Ho && gx < p.Wo)\n"
                  "          *reinterpret_cast<uint4*>(",
                  "        if (gy < p.Ho && gx < p.Wo && p.Cout < 0)\n"
                  "          *reinterpret_cast<uint4*>(")],
    # the MMAs skipped (loads, barriers and ldmatrix kept)
    "no_mma": [("    nesr::wgmma_rs<N>(acc, a[kk],",
                "    if (bs == 1u) nesr::wgmma_rs<N>(acc, a[kk],")],
    # the input patch not loaded (its buffer read as it is)
    "no_patch": [("      nesr::cp_async_zfill<VEC * 2>(",
                  "      if (p.Cout < 0) nesr::cp_async_zfill<VEC * 2>(")],
    # the weight slabs not copied (each slot's barrier completed at once)
    "no_weights": [("    nesr::bulk_load(ring_s + s * S::SLAB * 2, "
                    "p.wp + (size_t)g * S::SLAB,\n"
                    "                    S::SLAB * 2, full_s + 8 * s);",
                    "    nesr::mbar_arrive(full_s + 8 * s);")],
    # three blocks an SM (85 registers) for N <= 64 with <= 32-channel passes
    "narrow_three_blocks": [("__global__ void __launch_bounds__(THREADS, 2)",
                             "__global__ void __launch_bounds__(THREADS, "
                             "N <= 64 && KS <= 2 ? 3 : 2)")],
    # one set of A fragments, each tap waiting for its own MMAs
    "single_a": [("a[t & 1]", "a[0]"),
                 ("nesr::wgmma_wait<1>();", "nesr::wgmma_wait<0>();")],
}


# A copy of K1 that stamps %globaltimer (thread 0 of each block) at its
# phases: 0 start, 1 patch staged, 2 first slab in, 3 / 5 N tile 0 / 1's
# taps done, 4 / 6 N tile 0 / 1's stores issued.
TRACE_EDITS = [
    ('#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n'
     "__device__ unsigned long long k1_trace[1 << 20];\n"
     'extern "C" int k1_trace_copy(void* host, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, k1_trace, n * 8);\n}\n"
     "#define K1_MARK(i) if (threadIdx.x == 0) { unsigned long long t_; "
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
     "k1_trace[(blockIdx.z * gridDim.x + blockIdx.x) * 8 + (i)] = t_; }\n"),
    ("  constexpr int STAGES = S::STAGES, T = KT * KT;\n",
     "  constexpr int STAGES = S::STAGES, T = KT * KT;\n  K1_MARK(0);\n"),
    ("      cp_async_wait<0>();\n      __syncthreads();\n    }\n",
     "      cp_async_wait<0>();\n      __syncthreads();\n    }\n"
     "    if (nt == 0) K1_MARK(1);\n"),
    ("        nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);\n",
     "        nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);\n"
     "        if (g == 0) K1_MARK(2);\n"),
    ("      release(g0 + T - 1);\n    }\n",
     "      release(g0 + T - 1);\n    }\n"
     "    if (nt < 2) K1_MARK(3 + 2 * nt);\n"),
    ("    Epi::template write<N>(p, tile, n, oy, ox, co0, "
     "min(N, p.Cout - co0));\n",
     "    Epi::template write<N>(p, tile, n, oy, ox, co0, "
     "min(N, p.Cout - co0));\n    if (nt < 2) K1_MARK(4 + 2 * nt);\n"),
]


def _keep_widths(text: str) -> str:
    return re.sub(r"    case (\d+): return launch_ks<\d+>\(p, ks, N, s\);\n",
                  lambda m: m.group(0) if int(m.group(1)) in KEEP_WIDTHS
                  else "", text)


def _prepare(name: str, edits, **kw):
    return prepare(OUT, name, "conv3x3.cu", edits, finish=_keep_widths,
                   headers=("conv3x3_body.cuh",), **kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another csrc directory to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    k1 = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    jobs = {name: _prepare(name, edits, ptxas=name == "base")
            for name, edits in [*VARIANTS.items(), ("trace", TRACE_EDITS)]}
    if args.baseline:
        jobs["baseline"] = _prepare("baseline", [], ptxas=True,
                                    csrc=os.path.abspath(args.baseline))
    libs = {}
    for name, (so, _, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "_kernel" in line:
                print(f"{name} ptxas {line.split(chr(39))[1]}: " + " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]),
                    flush=True)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_conv3x3.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.nesr_conv3x3.restype = ci
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    n, h, w = 4, 268, 268
    cases = []
    for label, cin, cout in SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen).to("cuda",
                                                          torch.bfloat16)
        wt = (torch.randn((3, 3, cin, cout), generator=gen) * 0.05).to(
            "cuda", torch.bfloat16)
        y = torch.empty((n, h, w, cout), device="cuda", dtype=torch.bfloat16)
        cases.append((label, cin, cout, x, k1.pack_conv3x3_weights(wt), y))

    def run(lib, cin, cout, x, packed, y):
        err = lib.nesr_conv3x3(x.data_ptr(), packed.data_ptr(), None,
                               y.data_ptr(), n, h, w, cin, cout,
                               k1.tile_width(cout)[0], 0,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    def timed_case(lib, case) -> float:
        return timed(torch, lambda: run(lib, *case[1:]), REPS)

    trace = libs.pop("trace")
    trace.k1_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    trace.k1_trace_copy.restype = ctypes.c_int
    for case in cases:
        label, cin, cout, x, packed, y = case
        for _ in range(3):
            run(trace, cin, cout, x, packed, y)
        torch.cuda.synchronize()
        blocks = (-(-w // 16)) * (-(-h // 8)) * n
        stamps = torch.zeros(blocks * 8, dtype=torch.int64)
        if trace.k1_trace_copy(stamps.data_ptr(), blocks * 8):
            raise SystemExit("trace copy failed")
        st = stamps.view(blocks, 8).double() / 1e3   # us
        parts = [("start->patch", 0, 1), ("patch->slab0", 1, 2),
                 ("taps N tile 0", 2, 3), ("stores N tile 0", 3, 4),
                 ("taps N tile 1", 4, 5), ("stores N tile 1", 5, 6)]
        # a stamp older than the block's start is left from another shape
        fresh = [bool((st[:, b] >= st[:, a]).all() and
                      (st[:, a] >= st[:, 0]).all()) for _, a, b in parts]
        out = [f"{name} {(st[:, b] - st[:, a]).median().item():.2f}"
               for (name, a, b), ok in zip(parts, fresh) if ok]
        last = 6 if fresh[4] and fresh[5] else 4
        print(f"K1 trace {label}: {blocks} blocks over "
              f"{st[:, last].max().item() - st[:, 0].min().item():.1f} us; "
              f"median us a block "
              f"{(st[:, last] - st[:, 0]).median().item():.2f} = "
              + ", ".join(out), flush=True)

    order = ["baseline"] * bool(args.baseline) + list(VARIANTS) + ["base"]
    order += ["baseline"] * bool(args.baseline)
    for i, name in enumerate(order):
        label = name if name not in order[:i] else f"{name} (again)"
        times = [f"{case[0]} {timed_case(libs[name], case):.4f} ms"
                 for case in cases]
        print(f"K1 {label}: " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
