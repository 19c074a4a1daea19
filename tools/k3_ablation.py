"""Where K3's time goes: the kernel against copies of itself with one part
taken out, on one CUDA GPU.

    python3 tools/k3_ablation.py

Copies ``csrc/`` into ``build/k3_ablation/<variant>/``, edits each copy's
``flash_attn.cu`` as listed in VARIANTS (the edits are textual; a variant
whose text no longer matches fails loudly), builds each copy with its own
nvcc (all at once), prints the base build's ptxas report for K3 (registers,
spills, warnings), and times every variant at SHAPES by device time
(torch.profiler kernel durations over REPS launches), in the order base,
variants, base. The variants compute wrong outputs on purpose; only their
times mean anything. One more copy sums the SM clocks of each phase of a
narrow-form KV step (TRACE_EDITS), and the median over blocks is printed
for each d <= 128 shape. Prints the card (name, power limit) first.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import sys

from ablation_build import ROOT, prepare

OUT = os.path.join(ROOT, "build", "k3_ablation")
REPS = 10
# (label, B, H, Sq, Skv, d): chip_smoke.py's FLASH_SHAPES that lose most
SHAPES = [("unet 64^2 d64", 1, 8, 4096, 4096, 64),
          ("ragged 52x36 d64", 1, 8, 1872, 1872, 64),
          ("unet 32^2 d64", 1, 8, 1024, 1024, 64),
          ("vae 128^2 d512", 1, 1, 16384, 16384, 512),
          ("ragged 4000 d512", 1, 1, 4000, 4000, 512)]
# variant: [(old text, new text), ...] applied to flash_attn.cu, each to
# every place the old text appears (a compiled pattern substituted)
VARIANTS = {
    "base": [],
    # no Q/K/V copies: every tile's barrier completes at once
    "no_loads": [(re.compile(r"nesr::mbar_expect_tx\(([^,]+), [^;]+\);"),
                  r"nesr::mbar_arrive(\1);"),
                 ("nesr::tma_load_4d(", "if (b < 0) nesr::tma_load_4d(")],
    # S = Q K^T skipped (the softmax runs on whatever the registers hold)
    "no_s_mma": [("nesr::wgmma_ss<BK>(sc,", "if (a.D < 0) nesr::wgmma_ss<BK>(sc,")],
    # P V skipped
    "no_pv_mma": [("nesr::wgmma_rs_tb<DP>(\n",
                   "if (a.D < 0) nesr::wgmma_rs_tb<DP>(\n"),
                  ("nesr::wgmma_ss_tb<128>(acc,",
                   "if (a.D < 0) nesr::wgmma_ss_tb<128>(acc,")],
    # the softmax's exponentials replaced by the fused multiply-add alone
    "no_exp": [("s[4 * j + e] = ex2(fmaf(", "s[4 * j + e] = (fmaf(")],
    # three blocks an SM at d <= 64 instead of four
    "three_blocks": [("BLOCKS = DP <= 64 ? 4 : 2;", "BLOCKS = DP <= 64 ? 3 : 2;")],
    # the narrow form's softmax skipped (P is the raw scores)
    "no_softmax": [("  softmax_tile<BK>(sc, m, l, alpha, kv0, a.Skv, a.scale, t);",
                    "  if (a.D < 0) softmax_tile<BK>(sc, m, l, alpha, kv0, a.Skv,"
                    " a.scale, t);")],
    # the narrow form's accumulator not rescaled
    "no_rescale": [("      acc[4 * n] *= alpha[0];\n"
                    "      acc[4 * n + 1] *= alpha[0];\n"
                    "      acc[4 * n + 2] *= alpha[1];\n"
                    "      acc[4 * n + 3] *= alpha[1];\n    }\n"
                    "    nesr::mbar_wait(vfull",
                    "    }\n    nesr::mbar_wait(vfull")],
}


# A copy of K3 whose narrow form sums, in thread 0 of each block's consumer
# warpgroup, the SM clocks each phase of a KV step took: 0 between steps,
# 1 waiting for K_{j+1} and issuing S_{j+1}, 2 rescaling and waiting for
# V_j (after refilling the free K and V slots), 3 issuing P V_j, 4 waiting
# for S_{j+1}, 5 its softmax, 6 waiting for P V_j; slot 7 holds the step
# count.
_MARK = ("#define K3_MARK(i) { const long long n_ = clock64(); "
         "k3_acc[i] += n_ - k3_t; k3_t = n_; }\n")
TRACE_EDITS = [
    ('#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n'
     "__device__ long long k3_trace[1 << 16][8];\n"
     'extern "C" int k3_trace_copy(void* host, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, k3_trace, n * 64);\n}\n"
     + _MARK),
    ("  float sc[BK / 2];\n  uint32_t p0",
     "  long long k3_t = clock64(), k3_acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  float sc[BK / 2];\n  uint32_t p0"),
    ("    const bool more = j + 1 < nkv;\n    issue_s(sc, more ? j + 1 : j);\n",
     "    const bool more = j + 1 < nkv;\n    K3_MARK(0);\n"
     "    issue_s(sc, more ? j + 1 : j);\n    K3_MARK(1);\n"),
    ("    nesr::mbar_wait(vfull + 8 * (j % VST), (j / VST) & 1);\n",
     "    nesr::mbar_wait(vfull + 8 * (j % VST), (j / VST) & 1);\n"
     "    K3_MARK(2);\n"),
    ("    nesr::wgmma_commit();\n    nesr::wgmma_wait<1>();"
     "   // S_{j+1} has retired; P V_j may still run\n",
     "    nesr::wgmma_commit();\n    K3_MARK(3);\n    nesr::wgmma_wait<1>();\n"
     "    K3_MARK(4);\n"),
    ("    if (more) narrow_softmax<BK>(sc, pn, m, l, alpha, (j + 1) * BK, a, t);\n",
     "    if (more) narrow_softmax<BK>(sc, pn, m, l, alpha, (j + 1) * BK, a, t);\n"
     "    K3_MARK(5);\n"),
    ("nesr::reg_fence(acc[e]);\n  };",
     "nesr::reg_fence(acc[e]);\n    K3_MARK(6);\n  };"),
    ("  store_rows<DP>(a, acc, l, q0 + 16 * warp + g, 0, t);",
     "  if (tid == 0) {\n"
     "    long long* row = k3_trace[blockIdx.y * gridDim.x + blockIdx.x];\n"
     "    for (int i = 0; i < 7; ++i) row[i] = k3_acc[i];\n"
     "    row[7] = nkv;\n  }\n"
     "  store_rows<DP>(a, acc, l, q0 + 16 * warp + g, 0, t);"),
]
PHASES = ("between steps", "wait K + issue S", "refill + rescale + wait V",
          "issue P V", "wait S", "softmax", "wait P V")


def _prepare(name: str, edits):
    so, _, proc = prepare(OUT, name, "flash_attn.cu", edits, ptxas=True)
    return so, proc


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, device_ms
    print(card_line(), flush=True)
    jobs = {name: _prepare(name, edits) for name, edits in
            [*VARIANTS.items(), ("trace", TRACE_EDITS)]}
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        if name == "base":
            keep = [line for line in log.splitlines()
                    if "warning" in line.lower() or "Used" in line
                    or "spill" in line or "Compiling entry" in line]
            print("\n".join(keep), flush=True)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_flash_attn.argtypes = [vp] * 4 + [ci] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp]
        lib.nesr_flash_attn.restype = ci
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    cases = []
    for label, b, h, sq, skv, d in SHAPES:
        q, k, v = ((torch.randn(shape, generator=gen) * s).to(
            "cuda", torch.bfloat16) for shape, s in (
                ((b, h, sq, d), 2.0), ((b, h, skv, d), 2.0),
                ((b, h, skv, d), 1.0)))
        o = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, o) for s in t.stride()[:3]))
        cases.append((label, (q, k, v, o, b, h, sq, skv, d, st)))

    def run(lib, q, k, v, o, b, h, sq, skv, d, st):
        err = lib.nesr_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), b, h, sq, skv, d, st,
                                  1.0 / math.sqrt(d),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    trace = libs.pop("trace")
    trace.k3_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    trace.k3_trace_copy.restype = ctypes.c_int
    for case, args in cases:
        b, h, sq, d = args[4], args[5], args[6], args[8]
        if d > 128:
            continue
        run(trace, *args)
        torch.cuda.synchronize()
        blocks = -(-sq // 64) * b * h
        stamps = torch.zeros(blocks * 8, dtype=torch.int64)
        if trace.k3_trace_copy(stamps.data_ptr(), blocks):
            raise SystemExit("trace copy failed")
        st = stamps.view(blocks, 8).double()
        per_step = st[:, :7] / st[:, 7:8]
        med = per_step.median(dim=0).values
        print(f"K3 trace {case}: {blocks} blocks, median SM clocks a KV step "
              f"{med.sum().item():.0f} = " + ", ".join(
                  f"{name} {v:.0f}" for name, v in zip(PHASES, med.tolist())),
              flush=True)

    order = list(VARIANTS) + ["base"]
    for i, name in enumerate(order):
        label = name if i < len(order) - 1 else "base (again)"
        times = [f"{case} {device_ms(lambda: run(libs[name], *args), REPS):.4f}"
                 for case, args in cases]
        print(f"K3 {label} (device ms): " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
