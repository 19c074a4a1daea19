"""Where K1f's and K3f's time goes: each kernel against copies of itself
with one part taken out and, optionally, against another ``csrc``, on one
CUDA GPU.

    python3 tools/f32_ablation.py [--baseline CSRC_DIR]
                                  [--only k1f|k3f|step]

Copies ``csrc/`` into ``build/f32_ablation/<variant>/``, edits each copy's
K1f mainloop (``conv3x3_f32_body.cuh``, or ``conv3x3_f32.cu`` where a
``csrc`` has no such header) or ``flash_attn_f32.cu`` as listed in
K1F_VARIANTS and K3F_VARIANTS (textual edits; one whose text no longer
matches fails loudly), and builds each copy's source alone with its own
nvcc (all at once), printing the ptxas report (registers, spills) of the base build.
With ``--baseline`` the float32 kernels of another ``csrc`` directory (for
example a ``git archive`` of the parent commit under ``build/``) are built
and timed too, so two designs are compared within one call. The variants
compute wrong outputs on purpose; only their times mean anything. K3f's
``one_split`` is the base build called with the keys unsplit.

Times every build at the float32 path's shapes (K1f: the full trunk's five
convs and the head's on the 4 x 268^2 tile batch; K3f: chip_smoke.py's
FLASH_SHAPES and the VAE mid-block of a 48x40 request) with CUDA events
over REPS launches after a warm-up, in the order baseline, base, variants,
base, baseline, and prints each beside the bound (67 TFLOP/s float32,
3.35 TB/s) and the one PyTorch call computing the same function (cuDNN's
float32 conv with its bias, TF32 off; SDPA in float32). Prints the
card (name, power limit) first. ``step`` (the float32 RDB step,
``rdb_f32.cu``, which shares K1f's mainloop) has no variants: with
``--baseline`` it times the two builds' steps at an RDB's five launches on
the tile batch, in the same turns; no PyTorch call computes a step.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

from ablation_build import ROOT, prepare, timed

OUT = os.path.join(ROOT, "build", "f32_ablation")
REPS = 5
PEAK_FP32, PEAK_HBM = 67e12, 3.35e12
# (label, N, H, W, Cin, Cout)
K1F_SHAPES = [("trunk w0 64->192", 4, 268, 268, 64, 192),
              ("trunk w1 32->160", 4, 268, 268, 32, 160),
              ("trunk w2 32->128", 4, 268, 268, 32, 128),
              ("trunk w3 32->96", 4, 268, 268, 32, 96),
              ("trunk w4 32->64", 4, 268, 268, 32, 64),
              ("conv_first 12->64", 4, 268, 268, 12, 64),
              ("conv_body 64->64", 4, 268, 268, 64, 64),
              ("conv_up1 64->64", 4, 536, 536, 64, 64),
              ("conv_up2/hr 64->64", 4, 1072, 1072, 64, 64),
              ("conv_last 64->3", 4, 1072, 1072, 64, 3)]
# (label, B, H, Sq, Skv, d)
K3F_SHAPES = [("vae 1920^2 d512", 1, 1, 1920, 1920, 512),
              ("vae 128^2 d512", 1, 1, 16384, 16384, 512),
              ("unet 64^2 d64", 1, 8, 4096, 4096, 64),
              ("unet 32^2 d64", 1, 8, 1024, 1024, 64),
              ("unet 16^2 d128", 1, 8, 256, 256, 128),
              ("ragged 52x36 d64", 1, 8, 1872, 1872, 64),
              ("ragged 13x9 d128", 1, 8, 117, 117, 128),
              ("ragged 4000 d512", 1, 1, 4000, 4000, 512),
              ("cross 200x330 d64", 1, 8, 200, 330, 64)]
# variant: [(old text, new text), ...] applied to K1f's mainloop
K1F_VARIANTS = {
    # no FMAs: the staging and the barriers alone
    "no_fma": [("    for (int q = 0; q < nq; ++q) {",
                "    for (int q = 0; q < (a.Cin < 0 ? nq : 0); ++q) {")],
    # pass 0 staged, the later passes compute on it without copies or waits
    "no_staging": [("    if (p + 1 < passes) issue(p + 1);",
                    "    if (p + 1 < passes && p < 1) issue(p + 1);"),
                   ("    nesr::mbar_wait(bar0 + 8 * (p & 1), (p >> 1) & 1);",
                    "    if (p < 2) nesr::mbar_wait(bar0 + 8 * (p & 1), "
                    "(p >> 1) & 1);")],
}
# variant: edits of flash_attn_f32.cu
K3F_VARIANTS = {
    # no K/V copies after the prologue: the FMAs on stale stages
    "no_loads": [("    if (g + C::STAGES - 1 < nchunks) issue(g + C::STAGES - 1);",
                  "    if (g + C::STAGES - 1 < nchunks && g < 0) "
                  "issue(g + C::STAGES - 1);")],
    # S = q k^T skipped (the softmax runs on zeros)
    "no_s": [("      for (int d = 0; d < C::DC; d += 4) {",
              "      for (int d = 0; d < (a.D < 0 ? C::DC : 0); d += 4) {")],
    # P V skipped
    "no_pv": [("      for (int kk = 0; kk < C::KV; ++kk) {",
               "      for (int kk = 0; kk < (a.D < 0 ? C::KV : 0); ++kk) {")],
}


def _ptxas(log: str) -> list[str]:
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out.append(name + ": " + " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
    return out


def _bind(lib, split_api) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.POINTER(ctypes.c_longlong)
    if hasattr(lib, "nesr_conv3x3_f32"):
        lib.nesr_conv3x3_f32.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.nesr_conv3x3_f32.restype = ci
    if hasattr(lib, "nesr_rdb_f32_step"):
        lib.nesr_rdb_f32_step.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.nesr_rdb_f32_step.restype = ci
    if hasattr(lib, "nesr_flash_attn_f32"):
        lib.nesr_flash_attn_f32.argtypes = (
            [vp] * 6 + [ci] * 5 + [ll, ctypes.c_float] + [ci] * 4 + [vp]
            if split_api else [vp] * 4 + [ci] * 5 + [ll, ctypes.c_float, vp])
        lib.nesr_flash_attn_f32.restype = ci


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "ops" if t_ops >= t_bytes else "bytes"


def _k1f(torch, builds, order) -> None:
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, n, h, w, cin, cout in K1F_SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen).to("cuda")
        wt = (torch.randn((3, 3, cin, cout), generator=gen)
              * (2.0 / (9 * cin)) ** 0.5).to("cuda")
        b = (torch.randn((cout,), generator=gen) * 0.1).to("cuda")
        y = torch.empty((n, h, w, cout), device="cuda")

        def run(lib):
            err = lib.nesr_conv3x3_f32(x.data_ptr(), wt.data_ptr(),
                                       b.data_ptr(), y.data_ptr(), n, h, w,
                                       cin, cout, 1, stream)
            if err:
                raise SystemExit(f"K1f launch failed: CUDA error {err}")

        pix = n * h * w
        bms, by = _bound(2.0 * pix * cout * 9 * cin,
                         4.0 * (pix * (cin + cout) + 9 * cin * cout + cout))
        times = [(name, timed(torch, lambda: run(builds[name][0]), REPS))
                 for name in order]
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        times.append(("cuDNN f32", timed(
            torch, lambda: F.conv2d(xc, wc, b, padding=1), REPS)))
        print(f"K1f {label} on {(n, h, w)}: bound {bms:.4f} ms ({by}); " +
              ", ".join(f"{name} {ms:.4f}" for name, ms in times) +
              " ms a launch", flush=True)
        del x, y


def _step(torch, builds, order) -> None:
    """The float32 RDB step at each of an RDB's five launches (nf 64, g 32)
    on the tile batch, and the five together."""
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n, h, w = K1F_SHAPES[0][1:4]
    nf, g = 64, 32
    cs = 4 * g + nf
    x = torch.randn((n, h, w, nf), generator=gen).to("cuda")
    srcs = [x] + [torch.randn((n, h, w, g), generator=gen).to("cuda")
                  for _ in range(4)]
    ws = [(torch.randn((3, 3, nf if k == 0 else g, cs - k * g),
                       generator=gen) * 0.05).to("cuda") for k in range(5)]
    b = (torch.randn((cs,), generator=gen) * 0.1).to("cuda")
    slots = torch.zeros((n, h, w, cs), device="cuda")
    xn = torch.empty((n, h, w, g), device="cuda")
    out = torch.empty_like(x)

    def run(lib, k):
        err = lib.nesr_rdb_f32_step(
            srcs[k].data_ptr(), ws[k].data_ptr(), b.data_ptr(),
            slots.data_ptr(), None if k == 4 else xn.data_ptr(),
            x.data_ptr() if k == 4 else None, None,
            out.data_ptr() if k == 4 else None, n, h, w,
            srcs[k].shape[3], cs - k * g, k, g, cs, stream)
        if err:
            raise SystemExit(f"step {k} launch failed: CUDA error {err}")

    pix = n * h * w
    for k in (*range(5), None):
        ks = range(5) if k is None else (k,)
        flops = sum(2.0 * pix * 9 * srcs[j].shape[3] * (cs - j * g)
                    for j in ks)
        bms, by = _bound(flops, 4.0 * pix * (nf + cs))
        times = [(name, timed(torch, lambda lib=builds[name][0]: [
            run(lib, j) for j in ks], REPS)) for name in order]
        label = "an RDB (5 launches)" if k is None else f"step {k}"
        print(f"float32 RDB step {label} on {(n, h, w)}: bound {bms:.4f} ms "
              f"({by}); " + ", ".join(f"{name} {ms:.4f}"
                                      for name, ms in times) + " ms a call",
              flush=True)


def _k3f(torch, builds, order) -> None:
    import torch.nn.functional as F
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels.attention import (
        _f32_tiles, flash_f32_splits)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, h, sq, skv, d in K3F_SHAPES:
        q = (torch.randn((b, h, sq, d), generator=gen) * 2).to("cuda")
        k = (torch.randn((b, h, skv, d), generator=gen) * 2).to("cuda")
        v = torch.randn((b, h, skv, d), generator=gen).to("cuda")
        o = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, o) for s in t.stride()[:3]))
        # a build with key-range splits launches as the wrapper does
        # (one_split: the same with the keys unsplit)
        bq, bk = _f32_tiles(d)
        nsplit, kps = flash_f32_splits(sq, skv, b * h, d, sms)
        part = torch.empty((nsplit, b * h, sq, d), device="cuda")
        ml = torch.empty((nsplit, b * h, sq, 2), device="cuda")

        def run(name, one_split=False):
            lib, split_api = builds[name]
            if split_api:
                splits, per = nsplit, kps
                if one_split:
                    splits, per = 1, -(-skv // bk) * bk
                err = lib.nesr_flash_attn_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    part.data_ptr(), ml.data_ptr(), b, h, sq, skv, d, st,
                    1.0 / math.sqrt(d), splits, per, bq, bk, stream)
            else:
                err = lib.nesr_flash_attn_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, sq, skv, d, st, 1.0 / math.sqrt(d), stream)
            if err:
                raise SystemExit(f"K3f launch failed: CUDA error {err}")

        bms, by = _bound(4.0 * b * h * sq * skv * d,
                         4.0 * b * h * d * (2 * sq + 2 * skv))
        times = [(name, timed(torch, lambda: run(name), REPS))
                 for name in order]
        if nsplit > 1:
            times.append(("one_split", timed(
                torch, lambda: run("base", one_split=True), REPS)))
        times.append(("SDPA f32", timed(
            torch, lambda: F.scaled_dot_product_attention(q, k, v), REPS)))
        print(f"K3f {label} q {(b, h, sq, d)} Skv {skv}: base {nsplit} "
              f"split(s) of {kps} keys, {b * h * -(-sq // bq) * nsplit} "
              f"blocks; bound "
              f"{bms:.4f} ms ({by}); " +
              ", ".join(f"{name} {ms:.4f}" for name, ms in times) +
              " ms a launch", flush=True)
        del q, k, v, o, part, ml


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another csrc directory to time")
    ap.add_argument("--only", choices=("k1f", "k3f", "step"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("f32_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    kernels = [k for k in ("k1f", "k3f", "step") if args.only in (None, k)]
    for kern in kernels:
        source = {"k1f": "conv3x3_f32.cu", "k3f": "flash_attn_f32.cu",
                  "step": "rdb_f32.cu"}[kern]
        variants = {"k1f": K1F_VARIANTS, "k3f": K3F_VARIANTS,
                    "step": {}}[kern]
        headers = ("conv3x3_f32_body.cuh",) if kern == "k1f" else ()
        jobs = {"base": prepare(OUT, f"{kern}_base", source, ptxas=True)}
        if args.baseline:
            jobs["baseline"] = prepare(OUT, f"{kern}_baseline", source,
                                       csrc=os.path.abspath(args.baseline),
                                       ptxas=True)
        for name, edits in variants.items():
            jobs[name] = prepare(OUT, f"{kern}_{name}", source, edits,
                                 ptxas=True, headers=headers)
        builds = {}
        for name, (so, text, proc) in jobs.items():
            split_api = "int nsplit" in text
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"{kern} {name}: nvcc failed\n{log[-3000:]}")
            if name in ("base", "baseline"):
                for line in _ptxas(log):
                    print(f"{kern} {name} ptxas {line}", flush=True)
            lib = ctypes.CDLL(so)
            _bind(lib, split_api)
            builds[name] = (lib, split_api)
        order = ([n for n in ("baseline", "base") if n in builds]
                 + list(variants) + [n for n in ("base", "baseline")
                                     if n in builds])
        if kern == "k3f":
            _k3f(torch, builds, order)
        else:
            (_k1f if kern == "k1f" else _step)(
                torch, {n: (lib,) for n, (lib, _) in builds.items()}, order)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
