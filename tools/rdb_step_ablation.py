"""Where the K1 step's time goes: the kernel against copies of itself with
one part taken out, on one CUDA GPU, beside the composition it replaced.

    python3 tools/rdb_step_ablation.py [--baseline CSRC_DIR]

Copies ``csrc/`` into ``build/rdb_step_ablation/<variant>/``, edits each
copy's ``rdb_bf16.cu`` and the mainloop it includes, ``conv3x3_body.cuh``,
as listed in VARIANTS (textual edits; one that no longer matches fails
loudly), builds each copy with its own nvcc (all at
once, with the package's own library), and times each variant at the five
steps of the fused trunk's RDB (nf 64, g 32) on the 4 x 268 x 268 bf16
tile batch, with CUDA events over REPS launches after a warm-up, in the
order base, variants, base. With ``--baseline``, another ``csrc/`` (e.g.
a ``git archive`` of an earlier tree) is built unedited and timed first
and last, beside this one's. The variants compute wrong outputs on
purpose; only their times mean anything. Then, in turns, an RDB on the
package's steps and on ``FusedRDB._composition`` (five K1 convs with the
dense-block assembly in PyTorch: the default trunk's RDB before the
step). One more copy counts thread 0's SM clock in each phase of every N
tile (summed over a block's tiles) and prints the median block's split.
Prints the card (name, power limit), each variant's registers and spills
at the trunk's instantiations, and one line per variant.
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

OUT = os.path.join(ROOT, "build", "rdb_step_ablation")
REPS = 20
NF, G = 64, 32
# variant: [(old text, new text), ...] applied to rdb_bf16.cu and
# conv3x3_body.cuh
VARIANTS = {
    "base": [],
    # the patch not staged (the buffer read as it is; the L2 prefetch of
    # the next wave's patch kept)
    "no_patch": [("    if (restage) stage_pass<KS, KT>(p, patch, n, oy, ox, "
                  "0, pad);",
                  "    if (restage && p.H < 0) stage_pass<KS, KT>(p, patch, "
                  "n, oy, ox, 0, pad);\n"
                  "    else if (restage) cp_async_commit();")],
    # the L2 prefetch of the patch one wave later left out
    "no_l2_prefetch": [("    if (gy >= 0 && gy < p.H && x1 > x0)\n"
                        "      nesr::prefetch_l2(",
                        "    if (p.H < 0)\n      nesr::prefetch_l2(")],
    # the slots not prefetched (the staging tile read as it is)
    "no_slots": [("    prefetch_slots<N>(p, tile, n, oy, ox, co0, nvalid);",
                  "    if (p.H < 0) prefetch_slots<N>(p, tile, n, oy, ox, "
                  "co0, nvalid);")],
    # the MMAs skipped (weights, ldmatrix and barriers kept)
    "no_mma": [("nesr::wgmma_rs<N>(", "if (p.H < 0) nesr::wgmma_rs<N>(")],
    # the weight slabs not copied (each barrier completed at once)
    "no_weights": [("    nesr::bulk_load(ring_s + s * S::SLAB * 2, "
                    "p.wp + (size_t)g * S::SLAB,\n"
                    "                    S::SLAB * 2, full_s + 8 * s);",
                    "    nesr::mbar_arrive(full_s + 8 * s);")],
    # the coalesced epilogue skipped: no x_{k+1}, slot or out stores (and
    # no step-4 loads of x)
    "no_stores": [("    if (p.vec_out) write_tile<8, N>(p, tile, n, oy, ox, "
                   "co0, nvalid);\n    else write_tile<1, N>(p, tile, n, oy, "
                   "ox, co0, nvalid);\n",
                   "    if (p.H < 0) write_tile<8, N>(p, tile, n, oy, ox, "
                   "co0, nvalid);\n")],
    # one block an SM with up to 255 registers (no spill) instead of two
    # at 128
    "one_block_an_sm": [("__launch_bounds__(THREADS, 2)",
                         "__launch_bounds__(THREADS, 1)")],
}

PHASES = ("barrier before the N tile", "patch (and the slot copies issued)",
          "MMAs (weights, ldmatrix)", "slot wait", "fragment add",
          "coalesced stores")
# A copy that adds thread 0's clock64 since its last mark to the phase
# ending at each mark, and writes a block's sums at its end.
TRACE_EDITS = [
    ('#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n'
     "__device__ long long rs_trace[1 << 17];\n"
     'extern "C" int rs_trace_copy(void* host, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, rs_trace, n * 8);\n}\n"
     "#define RS_MARK(i) if (threadIdx.x == 0) { const long long t_ = "
     "clock64(); rs_t[i] += t_ - rs_last; rs_last = t_; }\n"),
    ("  const int npass = p.kp / S::KC;\n",
     "  const int npass = p.kp / S::KC;\n"
     "  long long rs_t[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long rs_last = clock64();\n"),
    ("    if (nt > 0 && (restage || Epi::prefetches(p))) __syncthreads();\n",
     "    if (nt > 0 && (restage || Epi::prefetches(p))) __syncthreads();\n"
     "    RS_MARK(0);\n"),
    ("#pragma unroll\n    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;\n",
     "    RS_MARK(1);\n#pragma unroll\n"
     "    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;\n"),
    ("    for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);\n",
     "    for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);\n"
     "    RS_MARK(2);\n"),
    ("    if (Epi::prefetches(p)) cp_async_wait<0>();\n    __syncthreads();\n",
     "    if (Epi::prefetches(p)) cp_async_wait<0>();\n    __syncthreads();\n"
     "    RS_MARK(3);\n"),
    ("    __syncthreads();\n    Epi::template write<N>",
     "    __syncthreads();\n    RS_MARK(4);\n    Epi::template write<N>"),
    ("    Epi::template write<N>(p, tile, n, oy, ox, co0, "
     "min(N, p.Cout - co0));\n  }\n}\n",
     "    Epi::template write<N>(p, tile, n, oy, ox, co0, "
     "min(N, p.Cout - co0));\n    RS_MARK(5);\n  }\n"
     "  if (threadIdx.x == 0)\n"
     "    for (int i = 0; i < 6; ++i)\n"
     "      rs_trace[(blockIdx.z * gridDim.x + blockIdx.x) * 6 + i] = "
     "rs_t[i];\n}\n"),
]


def _ptxas(log: str) -> str:
    """Registers and spills of the trunk's instantiations (<N, KS>)."""
    out = []
    want = {("96", "4"), ("80", "2"), ("128", "2"), ("96", "2"), ("64", "2")}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"rdb_bf16_step_kernelILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line and m.groups() in want:
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            out.append(f"<{m.group(1)},{m.group(2)}> "
                       f"{regs.group(1) if regs else '?'} registers, "
                       f"{spill.group(1) if spill else '?'} B spill stores")
    return "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another csrc directory to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rdb_step_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    k1 = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3")
    rr = importlib.import_module(
        "neural_enhanced_super_resolution_torch.models.rrdbnet")
    build = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels._build")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    jobs = {name: prepare(OUT, name, "rdb_bf16.cu", edits, ptxas=True,
                          headers=("conv3x3_body.cuh",))
            for name, edits in [*VARIANTS.items(), ("trace", TRACE_EDITS)]}
    if args.baseline:
        jobs["baseline"] = prepare(OUT, "baseline", "rdb_bf16.cu", ptxas=True,
                                   csrc=os.path.abspath(args.baseline))
    build.load_library()   # the package's own, for the composition
    libs = {}
    for name, (so, _, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        if "serialized" in log:
            print(f"{name}: ptxas serialized wgmma", flush=True)
        print(f"{name} ptxas: {_ptxas(log)}", flush=True)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_rdb_bf16_step.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        lib.nesr_rdb_bf16_step.restype = ci
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    n, h, w = 4, 268, 268
    cs = 4 * G + NF
    x = (torch.randn((n, h, w, NF), generator=gen) * 0.5).to(
        "cuda", torch.bfloat16)
    xk = (torch.randn((n, h, w, G), generator=gen) * 0.5).to(
        "cuda", torch.bfloat16)
    slots = torch.zeros((n, h, w, cs), device="cuda", dtype=torch.bfloat16)
    xn = torch.empty((n, h, w, G), device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)
    fw = [(torch.randn((3, 3, ci, co), generator=gen) * 0.05)
          for ci, co in ((NF, cs), (G, cs - G), (G, cs - 2 * G),
                         (G, cs - 3 * G), (G, NF))]
    bias = torch.randn((cs,), generator=gen) * 0.1
    rdb = rr.FusedRDB(fw, bias, torch.bfloat16, "cuda", kernel=False)
    steps = [(k, wk.shape[2], wk.shape[3], pk)
             for k, (wk, pk) in enumerate(zip(rdb.weights(), rdb.packed()))]

    def run(lib, k, cin, cout, packed):
        src = x if k == 0 else xk
        err = lib.nesr_rdb_bf16_step(
            src.data_ptr(), packed.data_ptr(), rdb.b.data_ptr(),
            slots.data_ptr(), xn.data_ptr() if k < 4 else None,
            x.data_ptr() if k == 4 else None, None,
            out.data_ptr() if k == 4 else None, n, h, w, cin, cout, k, G, cs,
            k1.tile_width(cout)[0], 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    trace = libs.pop("trace")
    trace.rs_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    trace.rs_trace_copy.restype = ctypes.c_int
    blocks = n * (-(-h // 8)) * (-(-w // 16))
    for step in steps:
        run(trace, *step)
        torch.cuda.synchronize()
        stamps = torch.zeros(blocks * 6, dtype=torch.int64)
        if trace.rs_trace_copy(stamps.data_ptr(), blocks * 6):
            raise SystemExit("trace copy failed")
        st = stamps.view(blocks, 6).double()
        tot = st.sum(dim=1)
        med = st[tot.argsort()[blocks // 2]]
        print(f"K1 step {step[0]} trace ({step[1]}->{step[2]}): median "
              f"block {med.sum().item():.0f} SM clocks = " + ", ".join(
                  f"{name} {100 * v / med.sum().item():.1f}%"
                  for name, v in zip(PHASES, med.tolist())), flush=True)
    order = list(VARIANTS) + ["base"]
    if args.baseline:
        order = ["baseline", *order, "baseline"]
    for i, name in enumerate(order):
        label = name if name not in order[:i] else f"{name} (again)"
        times = [timed(torch, lambda s=s: run(libs[name], *s), REPS)
                 for s in steps]
        print(f"K1 step {label}: " + "; ".join(
            f"step {k} {t:.4f} ms" for k, t in enumerate(times))
            + f"; RDB {sum(times):.4f} ms", flush=True)
    runs = {"steps": lambda: rdb(x), "composition": lambda: rdb._composition(x)}
    res = {key: [] for key in runs}
    for key in ("steps", "composition", "composition", "steps"):
        res[key].append(timed(torch, runs[key], REPS))
    print("an RDB in turns (steps, composition, composition, steps), ms: "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                      for k, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
