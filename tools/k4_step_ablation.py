"""Where the K4 step's time goes: the kernel against copies of itself with
one part taken out, on one CUDA GPU.

    python3 tools/k4_step_ablation.py

Copies ``csrc/`` into ``build/k4_step_ablation/<variant>/``, edits each
copy's ``rdb_int8.cu`` as listed in VARIANTS (textual edits; one that no
longer matches fails loudly), builds each copy with its own nvcc (all at
once), and times each variant at the five steps of the int8 trunk's RDB
(nf 64, g 32) on the 4 x 268 x 268 bf16 tile batch, with CUDA events over
REPS launches after a warm-up, in the order base, variants, base. The
variants compute wrong outputs on purpose; only their times mean
anything. One more copy counts thread 0's SM clock in each phase of every
N tile (summed over a block's tiles) and prints the median block's split.
Prints the card (name, power limit) and one line per variant.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import subprocess
import sys

from ablation_build import ROOT, prepare, timed

OUT = os.path.join(ROOT, "build", "k4_step_ablation")
REPS = 20
NF, G = 64, 32
# variant: [(old text, new text), ...] applied to rdb_int8.cu
VARIANTS = {
    "base": [],
    # the coalesced epilogue skipped: no x_{k+1}, slot or out stores (and
    # no step-4 loads of x)
    "no_write_tile": [("      m = p.vec\n", "      if (p.H < 0) m = p.vec\n")],
    # the slots not prefetched (the staging tile read as it is)
    "no_slots": [("        prefetch_slots<N>(p, tile, n, oy, ox, co0, "
                  "nvalid);",
                  "        if (p.H < 0) prefetch_slots<N>(p, tile, n, oy, "
                  "ox, co0, nvalid);")],
    # the raw patch not loaded (the buffer quantised as it is)
    "no_raw": [("    if (p.src_bf16) load_raw<S::KC, 8>(p, raw, n0, oy0, "
                "ox0);\n    else load_raw<S::KC, 4>(p, raw, n0, oy0, ox0);\n",
                "")],
    # the quantise pass skipped (the int8 patch read as it is)
    "no_quantise": [("        if (p.src_bf16) quantise_raw<S::KC, 8>(raw, "
                     "patch, r);\n        else quantise_raw<S::KC, 4>(raw, "
                     "patch, r);\n", "")],
    # the MMAs skipped (weights, ldmatrix and barriers kept)
    "no_mma": [("nesr::wgmma_rs_s8<N>(",
                "if (p.H < 0) nesr::wgmma_rs_s8<N>(")],
    # the weight slabs not copied (each barrier completed at once)
    "no_weights": [("    nesr::bulk_load(ring_s + s * S::SLAB,\n"
                    "                    p.wp + (size_t)(g % per_tile) * "
                    "S::SLAB, S::SLAB,\n"
                    "                    full_s + 8 * s);",
                    "    nesr::mbar_arrive(full_s + 8 * s);")],
}

PHASES = ("tile start", "N tile barrier", "patch (raw wait, quantise)",
          "MMAs (weights, ldmatrix)", "slot wait", "fragment add",
          "coalesced epilogue", "end")
# A copy that adds thread 0's clock64 since its last mark to the phase
# ending at each mark, and writes a block's eight sums at its end.
TRACE_EDITS = [
    ('#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n'
     "__device__ long long k4s_trace[1 << 16];\n"
     'extern "C" int k4s_trace_copy(void* host, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, k4s_trace, n * 8);\n}\n"
     "#define K4S_MARK(i) if (threadIdx.x == 0) { const long long t_ = "
     "clock64(); k4s_t[i] += t_ - k4s_last; k4s_last = t_; }\n"),
    ("  const int npass = p.kp / S::KC;\n",
     "  const int npass = p.kp / S::KC;\n"
     "  long long k4s_t[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long k4s_last = clock64();\n"),
    ("    origin(t_idx, n, oy, ox);\n",
     "    origin(t_idx, n, oy, ox);\n    K4S_MARK(0);\n"),
    ("      worker_sync(wg);   // the last N tile's staging and patch are "
     "free\n",
     "      worker_sync(wg);   // the last N tile's staging and patch are "
     "free\n      K4S_MARK(1);\n"),
    ("      for (int c = 0; c < npass; ++c) {\n",
     "      K4S_MARK(2);\n      for (int c = 0; c < npass; ++c) {\n"),
    ("      for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);\n",
     "      for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);\n"
     "      K4S_MARK(3);\n"),
    ("      worker_sync(wg);\n#pragma unroll\n      for (int j = 0; j < N / 8;"
     " ++j) {\n",
     "      worker_sync(wg);\n      K4S_MARK(4);\n#pragma unroll\n"
     "      for (int j = 0; j < N / 8; ++j) {\n"),
    ("      worker_sync(wg);\n      m = p.vec\n",
     "      worker_sync(wg);\n      K4S_MARK(5);\n      m = p.vec\n"),
    ("              : write_tile<1, N>(p, tile, cbias, n, oy, ox, co0, "
     "nvalid, m);\n",
     "              : write_tile<1, N>(p, tile, cbias, n, oy, ox, co0, "
     "nvalid, m);\n      K4S_MARK(6);\n"),
    ("  block_amax(m, red, p.s_out);\n}\n",
     "  block_amax(m, red, p.s_out);\n  K4S_MARK(7);\n"
     "  if (threadIdx.x == 0)\n"
     "    for (int i = 0; i < 8; ++i) k4s_trace[blockIdx.x * 8 + i] = "
     "k4s_t[i];\n}\n"),
]


def _prepare(name: str, edits):
    return prepare(OUT, name, "rdb_int8.cu", edits)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_step_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    k4 = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3_int8")
    tw = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3").tile_width
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    jobs = {name: _prepare(name, edits) for name, edits in
            [*VARIANTS.items(), ("trace", TRACE_EDITS)]}
    libs = {}
    for name, (so, _, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_rdb_int8_step.argtypes = [vp] * 11 + [ci] * 12 + [vp]
        lib.nesr_rdb_int8_step.restype = ci
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    n, h, w = 4, 268, 268
    cs = 4 * G + NF
    x = torch.randn((n, h, w, NF), generator=gen).to("cuda", torch.bfloat16)
    xk = torch.randn((n, h, w, G), generator=gen).to("cuda")
    slots = torch.zeros((n, h, w, cs), device="cuda", dtype=torch.bfloat16)
    xn = torch.empty((n, h, w, G), device="cuda")
    out = torch.empty_like(x)
    bias = (torch.randn((cs,), generator=gen) * 0.1).to("cuda")
    scales = torch.full((6,), 4.0, device="cuda")
    steps = []
    for k in range(5):
        cin, cout = (NF, cs) if k == 0 else (G, cs - k * G)
        wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                           dtype=torch.int8).to("cuda")
        w_s = (torch.rand((cout,), generator=gen) * 1e-3).to("cuda")
        steps.append((k, cin, cout, k4.pack_conv3x3_int8_weights(wq), w_s))

    def run(lib, k, cin, cout, packed, w_s):
        src = x if k == 0 else xk
        err = lib.nesr_rdb_int8_step(
            src.data_ptr(), packed.data_ptr(), w_s.data_ptr(),
            bias.data_ptr(), scales[k].data_ptr(), scales[k + 1].data_ptr(),
            slots.data_ptr(), xn.data_ptr() if k < 4 else None,
            x.data_ptr() if k == 4 else None, None,
            out.data_ptr() if k == 4 else None, n, h, w, cin, cout, k, G, cs,
            tw(cout)[0], int(k == 0), 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    trace = libs.pop("trace")
    trace.k4s_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    trace.k4s_trace_copy.restype = ctypes.c_int
    blocks = min(2 * torch.cuda.get_device_properties(0).multi_processor_count,
                 n * (-(-h // 8)) * (-(-w // 16)))
    for step in steps:
        run(trace, *step)
        torch.cuda.synchronize()
        stamps = torch.zeros(blocks * 8, dtype=torch.int64)
        if trace.k4s_trace_copy(stamps.data_ptr(), blocks * 8):
            raise SystemExit("trace copy failed")
        st = stamps.view(blocks, 8).double()
        tot = st.sum(dim=1)
        med = st[tot.argsort()[blocks // 2]]
        print(f"K4 step {step[0]} trace ({step[1]}->{step[2]}): median "
              f"block {med.sum().item():.0f} SM clocks = " + ", ".join(
                  f"{name} {100 * v / med.sum().item():.1f}%"
                  for name, v in zip(PHASES, med.tolist())), flush=True)
    order = list(VARIANTS) + ["base"]
    for i, name in enumerate(order):
        label = name if i < len(order) - 1 else "base (again)"
        times = [timed(torch, lambda s=s: run(libs[name], *s), REPS)
                 for s in steps]
        print(f"K4 step {label}: " + "; ".join(
            f"step {k} {t:.4f} ms" for k, t in enumerate(times))
            + f"; RDB {sum(times):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
