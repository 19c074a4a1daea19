"""Where the K1 step's time goes: the kernel against copies of itself with
one part taken out, on one CUDA GPU, beside the composition it replaced.

    python3 tools/rdb_step_ablation.py [--baseline CSRC_DIR]

Copies ``csrc/`` into ``build/rdb_step_ablation/<variant>/``, edits each
copy's ``rdb_bf16.cu`` and the mainloop pieces it includes from
``conv3x3_body.cuh``, as listed in VARIANTS (textual edits; one that no
longer matches fails loudly), builds each copy with its own nvcc (all at
once, with the package's own library), and times each variant at the five
steps of the fused trunk's RDB (nf 64, g 32) on the 4 x 268 x 268 bf16
tile batch, with CUDA events over REPS launches after a warm-up, in the
order base, variants, base. "streamed" reloads every step's weights for
every round of two tiles instead of keeping them for the block's life.
With ``--baseline``, another ``csrc/`` (e.g. a ``git archive`` of an
earlier tree, whose step takes the earlier C signature) is built unedited
and timed first and last, beside this one's. The variants compute wrong
outputs on purpose; only their times mean anything. Then, in turns, an
RDB on the package's steps and on ``FusedRDB._composition`` (five K1
convs with the dense-block assembly in PyTorch: the default trunk's RDB
before the step). One more copy defines the kernel's phase hooks: each
consumer's thread 0 and the producer's lane 0 sum their SM clock by
phase, and the median block's split is printed for each role. Prints
the card (name, power limit) and each build's registers and spills at
the trunk's five instantiations.
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
    # the producer loads nothing (no patch, slots, x or skip; the stage
    # barriers still complete)
    "no_producer_loads": [("  if (p.bulk) {\n    const uint32_t st_s",
                           "  if (p.bulk && p.H >= 0) {\n"
                           "    nesr::mbar_arrive(full);\n    return;\n  }\n"
                           "  if (p.bulk) {\n    const uint32_t st_s")],
    # the slot channels not loaded (the sums added to what the tile holds)
    "no_slots": [("(p.k > 0 ? SPX * p.tp * 2 : 0)",
                  "(p.k > 0 && p.H < 0 ? SPX * p.tp * 2 : 0)"),
                 ("    if (p.k > 0)\n      nesr::tma_load_4d(",
                  "    if (p.k > 0 && p.H < 0)\n      nesr::tma_load_4d(")],
    # the epilogue's copies skipped: no x_{k+1}, slot or out stores (the
    # sums and the dense output still staged)
    "no_stores": [("    bulk_store(", "    if (p.H < 0) bulk_store(")],
    # only the slot channels' copies (a pixel each) skipped
    "no_slot_stores": [("    if (gy < p.H && gx < p.W)\n"
                        "      bulk_store(p.slots",
                        "    if (gy < p.H && gx < p.W && p.H < 0)\n"
                        "      bulk_store(p.slots")],
    # only x_{k+1}'s or out's copies (a tile row each) skipped
    "no_out_stores": [("    if (gy < p.H)\n      bulk_store(dst",
                       "    if (gy < p.H && p.H < 0)\n      bulk_store(dst")],
    # the MMAs skipped (weights, ldmatrix and barriers kept)
    "no_mma": [("    nesr::wgmma_rs<N>(acc, a[kk],",
                "    if (bs == 1u) nesr::wgmma_rs<N>(acc, a[kk],")],
    # the weights reloaded for every round of tiles (an epoch a round)
    "streamed": [("  p.epoch = (p.tiles + 2 * grid - 1) / (2 * grid);",
                  "  p.epoch = 1;")],
    # the two consumers' MMA phases not ordered (no ping-pong)
    "unordered": [("      if (c == 1 || i > 0) named_sync(",
                   "      if (p.H < 0) named_sync("),
                  ("          if (c ? it0 > i + 1 : it1 > i) named_arrive(",
                   "          if (p.H < 0) named_arrive(")],
}

CONSUMER = ("stage wait", "turn wait", "MMAs", "stage release",
            "fragment adds", "tile barrier", "dense output",
            "fence and barrier", "store issue")
PRODUCER = ("empty wait", "issue loads")
MARKS = 10   # phase sums a role
# A copy whose phase hooks sum each role's clock64 by phase and write the
# sums of consumer 0, consumer 1 and the producer (roles 0-2) of each block.
TRACE_EDITS = [
    ('#include "conv3x3_body.cuh"\n',
     "__device__ long long rs_trace[1 << 16];\n"
     'extern "C" int rs_trace_copy(void* host, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, rs_trace, n * 8);\n}\n"
     "#define STEP_TRACE_BEGIN long long rs_t[10] = {}; "
     "long long rs_last = clock64();\n"
     "#define STEP_MARK(i) { const long long t_ = clock64(); "
     "rs_t[i] += t_ - rs_last; rs_last = t_; }\n"
     "#define STEP_TRACE_END(role) if (threadIdx.x % 128 == 0) "
     "for (int i_ = 0; i_ < 10; ++i_) "
     "rs_trace[(blockIdx.x * 3 + (role)) * 10 + i_] = rs_t[i_];\n"
     '#include "conv3x3_body.cuh"\n'),
]
# the trunk's five instantiations (<N, KS>)
WANT = (("96", "4"), ("80", "2"), ("128", "2"), ("96", "2"), ("64", "2"))


def _ptxas(log: str) -> str:
    """Registers and spills of the trunk's instantiations."""
    out = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"rdb_bf16_step_kernelILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line and m.groups() in WANT:
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            st = re.search(r"(\d+) bytes spill stores", text)
            ld = re.search(r"(\d+) bytes spill loads", text)
            out.append(f"<{m.group(1)},{m.group(2)}> "
                       f"{regs.group(1) if regs else '?'} registers, spill "
                       f"stores {st.group(1) if st else '?'} B, loads "
                       f"{ld.group(1) if ld else '?'} B")
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
    step = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb")
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
    libs, old = {}, set()
    for name, (so, text, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        if "serialized" in log:
            print(f"{name}: ptxas serialized wgmma", flush=True)
        print(f"{name} ptxas: {_ptxas(log)}", flush=True)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # the earlier one-tile-a-block step took no launch plan
        plan_args = "int grid, int nps" in text
        if not plan_args:
            old.add(name)
        lib.nesr_rdb_bf16_step.argtypes = ([vp] * 8 + [ci] * (15 if plan_args
                                                            else 10) + [vp])
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    steps = [(k, wk.shape[2], wk.shape[3], pk)
             for k, (wk, pk) in enumerate(zip(rdb.weights(), rdb.packed()))]

    def run(name, k, cin, cout, packed):
        lib = libs[name]
        src = x if k == 0 else xk
        common = (src.data_ptr(), packed.data_ptr(), rdb.b.data_ptr(),
                  slots.data_ptr(), xn.data_ptr() if k < 4 else None,
                  x.data_ptr() if k == 4 else None, None,
                  out.data_ptr() if k == 4 else None, n, h, w, cin, cout, k,
                  G, cs, k1.tile_width(cout)[0], 1)
        if name in old:
            err = lib.nesr_rdb_bf16_step(
                *common, torch.cuda.current_stream().cuda_stream)
        else:
            plan = step.step_plan(k, cin, cout, NF, n, h, w, sms)
            err = lib.nesr_rdb_bf16_step(
                *common, plan.grid, plan.nps, plan.stages, int(plan.bulk),
                plan.smem,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: launch failed: CUDA error {err}")

    libs["trace"].rs_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    libs["trace"].rs_trace_copy.restype = ctypes.c_int
    for st in steps:
        plan = step.step_plan(st[0], st[1], st[2], NF, n, h, w, sms)
        run("trace", *st)
        torch.cuda.synchronize()
        stamps = torch.zeros(plan.grid * 3 * MARKS, dtype=torch.int64)
        if libs["trace"].rs_trace_copy(stamps.data_ptr(),
                                       plan.grid * 3 * MARKS):
            raise SystemExit("trace copy failed")
        roles = stamps.view(plan.grid, 3, MARKS).double()
        parts = []
        for role, names in ((0, CONSUMER), (1, CONSUMER), (2, PRODUCER)):
            r = roles[:, role, :len(names)]
            tot = r.sum(dim=1)
            med = r[tot.argsort()[plan.grid // 2]]
            label = f"consumer {role}" if role < 2 else "producer"
            total = max(med.sum().item(), 1)
            parts.append(f"{label} {total:.0f} clocks = " + ", ".join(
                f"{nm} {100 * v / total:.1f}%"
                for nm, v in zip(names, med.tolist())))
        print(f"K1 step {st[0]} trace ({st[1]}->{st[2]}, <{plan.n_width},"
              f"{plan.ks}>, grid {plan.grid}, {plan.nps} N tile(s) a sweep, "
              f"{plan.stages} stages, smem {plan.smem} B): median block: "
              + "; ".join(parts), flush=True)
    libs.pop("trace")
    order = list(VARIANTS) + ["base"]
    if args.baseline:
        order = ["baseline", *order, "baseline"]
    for i, name in enumerate(order):
        label = name if name not in order[:i] else f"{name} (again)"
        times = [timed(torch, lambda s=s: run(name, *s), REPS)
                 for s in steps]
        print(f"K1 step {label}: " + "; ".join(
            f"step {k} {t:.4f} ms" for k, t in enumerate(times))
            + f"; RDB {sum(times):.4f} ms", flush=True)
    runs = {"steps": lambda: rdb(x),
            "composition": lambda: rdb._composition(x)}
    res = {key: [] for key in runs}
    for key in ("steps", "composition", "composition", "steps"):
        res[key].append(timed(torch, runs[key], REPS))
    print("an RDB in turns (steps, composition, composition, steps), ms: "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                      for k, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
