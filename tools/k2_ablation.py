"""Where K2's time goes: a phase clock per stage, on one CUDA GPU.

    python3 tools/k2_ablation.py [--baseline CSRC_DIR] [--faults]

Copies ``csrc/`` into ``build/k2_ablation/<variant>/`` and builds each
copy's ``rdb_fused.cu`` with its own nvcc (all at once):

* ``base``: the kernel as it is;
* ``clock``: the same source with its phase-clock hooks defined
  (``K2_CLOCK``): thread 0 of each block charges the SM clocks (``clock64``)
  since its previous mark to (stage, phase), phase 0 waiting for weights,
  1 the MMAs, 2 the epilogue, 3 waiting for the other warps (barriers);
  "stage 5" is the input staging before stage 0;
* ``baseline`` (with ``--baseline``): the ``rdb_fused.cu`` of another
  ``csrc`` directory, e.g. a ``git archive`` of the parent commit, so two
  designs are compared within one call.

With ``--faults``, builds the planted faults of FAULTS (textual edits of
``rdb_fused.cu``; an edit whose text no longer matches fails loudly) and
runs ``chip_smoke.check_rdb_fused`` with each in place of the kernel: the
check must fail every one (it prints each fault's error beside its bar),
and the tool exits 1 naming each fault the check passes. On an H100 the
check passes ``early_release``: its refill lands after the MMAs that read
the slot have run (PERF.md, K2 planted faults).

Times each copy on the 4 x 268 x 268 tile batch with CUDA events over REPS
launches after a warm-up, in the order baseline, base, clock, base,
baseline, and prints the clock copy's median clocks a block per
stage and phase with each phase's share of the block's clocks. A source
that issues ``wgmma`` takes K1's packed weights
(``kernels/conv3x3.py:pack_conv3x3_weights``), an older one HWIO weights.
Prints the card (name, power limit) first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

from ablation_build import CSRC, ROOT, prepare, timed

OUT = os.path.join(ROOT, "build", "k2_ablation")
REPS = 20
N, H, W = 4, 268, 268
SHAPES = ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64))
STAGES, PHASES = 6, ("weights", "MMA", "epilogue", "waits")
CLOCK_DEFS = (
    "#define K2_CLOCK 1\n"
    "__device__ long long k2_clock[1 << 18];\n"
    "__shared__ long long k2_acc[24];\n"
    "__shared__ long long k2_last;\n"
    'extern "C" int k2_clock_copy(void* host, int n) {\n'
    "  return (int)cudaMemcpyFromSymbol(host, k2_clock, n * 8);\n}\n"
    "#define K2_CLOCK_INIT if (threadIdx.x == 0) { for (int i_ = 0; i_ < 24;"
    " ++i_) k2_acc[i_] = 0; k2_last = clock64(); }\n"
    "#define K2_PHASE(s, p) if (threadIdx.x == 0) { long long t_ = clock64();"
    " k2_acc[(s) * 4 + (p)] += t_ - k2_last; k2_last = t_; }\n"
    "#define K2_CLOCK_STORE if (threadIdx.x == 0) { for (int i_ = 0; i_ < 24;"
    " ++i_) k2_clock[(blockIdx.y * gridDim.x + blockIdx.x) * 24 + i_] = "
    "k2_acc[i_]; }\n")


# Planted faults: [(old text, new text), ...] applied to rdb_fused.cu.
FAULTS = {
    # conv 5 (c4) left out of x5
    "c4_dropped": [("a.x + c0 + c.bias[4 * GROW + ch]",
                    "a.x + c.bias[4 * GROW + ch]"),
                   ("a.y + c1 + c.bias[4 * GROW + ch + 1]",
                    "a.y + c.bias[4 * GROW + ch + 1]")],
    # stage 2's slot adds (into a4 and a5) skipped
    "slot_add_skipped": [
        ("    *slot = __floats2bfloat162_rn(a.x + c0, a.y + c1);",
         "    if (S != 2) *slot = __floats2bfloat162_rn(a.x + c0, a.y + c1);")],
    # conv 5's bias left out of x5
    "conv5_bias_dropped": [(" + c.bias[4 * GROW + ch]", ""),
                           (" + c.bias[4 * GROW + ch + 1]", "")],
    # a ring slot released before the wgmma that reads it retires, and
    # refilled at once
    "early_release": [
        ("          nesr::wgmma_wait<1>();\n          release(g - 1);",
         "          release(g - 1);\n          nesr::wgmma_wait<1>();"),
        ("g >= 2 && g - 2 + RING < NSLAB", "g >= 1 && g - 1 + RING < NSLAB"),
        ("((g - 2) % RING),\n                          ((g - 2) / RING)",
         "((g - 1) % RING),\n                          ((g - 1) / RING)"),
        ("issue_slab(p, c, g - 2 + RING);", "issue_slab(p, c, g - 1 + RING);")],
}


class _Swapped:
    """The port's kernel library with K2's entry point taken from another
    build."""

    def __init__(self, lib, k2):
        self._lib, self.nesr_rdb_fused = lib, k2.nesr_rdb_fused

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _prepare(name: str, csrc: str, prefix: str = "", edits=()):
    packed = []   # whether the source (before the prefix) issues wgmma

    def finish(text: str) -> str:
        if prefix and "K2_PHASE(" not in text:
            raise SystemExit(f"{name}: rdb_fused.cu has no phase hooks")
        packed.append("wgmma" in text)
        return prefix + text
    so, _, proc = prepare(OUT, name, "rdb_fused.cu", edits, csrc=csrc,
                          finish=finish)
    return so, packed[0], proc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another csrc directory to time")
    ap.add_argument("--faults", action="store_true",
                    help="hold check_rdb_fused to the planted faults")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        pack_conv3x3_weights)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    jobs = {"base": _prepare("base", CSRC),
            "clock": _prepare("clock", CSRC, CLOCK_DEFS)}
    if args.baseline:
        jobs["baseline"] = _prepare("baseline", os.path.abspath(
            args.baseline))
    if args.faults:
        for name, edits in FAULTS.items():
            jobs[name] = _prepare(name, CSRC, edits=edits)
    libs = {}
    for name, (so, packed, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nesr_rdb_fused.argtypes = [vp] * 8 + [ci, ci, ci, vp]
        lib.nesr_rdb_fused.restype = ci
        libs[name] = (lib, packed)

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((N, H, W, 64), generator=gen) * 0.5).to(
        "cuda", torch.bfloat16)
    ws = [(torch.randn((3, 3, cin, cout), generator=gen) * 0.05).to(
        "cuda", torch.bfloat16) for cin, cout in SHAPES]
    wp = [pack_conv3x3_weights(w) for w in ws]
    b = (torch.randn((192,), generator=gen) * 0.1).to("cuda")
    y = torch.empty_like(x)

    def run(name):
        lib, packed = libs[name]
        err = lib.nesr_rdb_fused(
            x.data_ptr(), *[t.data_ptr() for t in (wp if packed else ws)],
            b.data_ptr(), y.data_ptr(), N, H, W,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: launch failed: CUDA error {err}")

    order = [name for name in ("baseline", "base", "clock", "base",
                               "baseline") if name in libs]
    for name in order:
        ms = timed(torch, lambda: run(name), REPS)
        print(f"K2 {name}: {ms:.4f} ms a launch (events, "
              f"{REPS} launches) on {tuple(x.shape)}", flush=True)

    lib = libs["clock"][0]
    lib.k2_clock_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.k2_clock_copy.restype = ctypes.c_int
    run("clock")
    torch.cuda.synchronize()
    blocks = N * (-(-H // 8)) * (-(-W // 8))
    stamps = torch.zeros(blocks * 24, dtype=torch.int64)
    if lib.k2_clock_copy(stamps.data_ptr(), blocks * 24):
        raise SystemExit("clock copy failed")
    clk = stamps.view(blocks, STAGES, 4).double()
    total = clk.sum(dim=(1, 2))
    print(f"K2 phase clock: {blocks} blocks, median "
          f"{total.median().item():.0f} SM clocks a block (thread 0)",
          flush=True)
    mean_total = total.mean().item()
    for s in range(STAGES):
        label = "input staging" if s == 5 else f"stage {s}"
        parts = [f"{p} {clk[:, s, i].median().item():.0f} "
                 f"({clk[:, s, i].mean().item() / mean_total:.1%})"
                 for i, p in enumerate(PHASES) if clk[:, s, i].any()]
        print(f"K2 phase clock {label}: " + ", ".join(parts), flush=True)
    shares = [clk[:, :, i].sum().item() / total.sum().item()
              for i in range(4)]
    print("K2 phase clock, all stages: " + ", ".join(
        f"{p} {v:.1%}" for p, v in zip(PHASES, shares)), flush=True)
    if args.faults:
        return _check_faults(torch, {k: libs[k][0] for k in FAULTS})
    return 0


def _check_faults(torch, faults) -> int:
    """chip_smoke.check_rdb_fused with the kernel, then with each planted
    fault in its place: it must pass the first and fail every fault."""
    import chip_smoke
    from neural_enhanced_super_resolution_torch.kernels import _build
    real = _build.load_library()
    missed = []
    for name in ["none", *faults]:
        _build._lib = real if name == "none" else _Swapped(real, faults[name])
        try:
            chip_smoke.check_rdb_fused(torch, torch.Generator().manual_seed(0))
            caught = False
        except AssertionError as exc:
            caught = True
            print(f"K2 planted fault {name}: check_rdb_fused fails ({exc})",
                  flush=True)
        if caught == (name == "none"):
            missed.append(name)
        elif name == "none":
            print("K2 planted fault none: check_rdb_fused passes", flush=True)
    _build._lib = real
    if missed:
        print(f"K2 planted faults: the check is wrong about {missed}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
