"""Where the folded head's 2x2 forms spend their time: K1's (bf16) and
K1f's (float32) 2x2 convs at the head's two shapes, each against copies of
itself with one part taken out and, optionally, against another ``csrc``,
on one CUDA GPU.

    python3 tools/head_ablation.py [--base CSRC_DIR] [--baseline CSRC_DIR]
                                   [--only bf16|f32]

The shapes are the folded head's on the 4 x 268^2 tile batch: hr, 4 x 536^2
x 256 -> 256 at padding 1 with LeakyReLU and the frame mask, and last, 4 x
537^2 x 256 -> 12 VALID, stored depth-to-space. Each build's source is
copied into ``build/head_ablation/<build>/``, the variants' copies edited as
their design's table lists (textual edits; one whose text no longer
matches fails loudly), and every copy is built by its own nvcc, all at
once; the ptxas report (registers, spills) of each unedited build is
printed. The variants compute wrong outputs on purpose; only their times
mean anything.

Which tables apply is read from the csrc directory: the earlier design
had the 2x2 forms in ``conv3x3.cu`` and ``conv3x3_f32.cu`` (the 3x3
kernels' bodies with two taps); the redesign has them in ``conv2x2.cu``
and ``conv2x2_f32.cu``. ``--baseline`` (e.g. a ``git archive`` of the parent
commit under ``build/``) times that directory's unedited forms in turns
with this one's (baseline, base, variants, base, baseline), and in the
same turns K1's trunk w0 / w2 / w4 / conv_body and the head's 3x3 up1 / up2,
and K1f's trunk w0 / up1 / up2, which the redesign must leave level.

Each time is CUDA events over REPS launches after a warm-up, printed
beside the bound (989 TFLOP/s bf16, 67 TFLOP/s float32, 3.35 TB/s), cuDNN's
conv at the same shape and padding (bf16, or float32 with TF32 off) and
the plain version ``conv2x2_s2d_plain``. Prints the card (name, power
limit) first. ``--base`` ablates another csrc than the package's (an
earlier commit's, to read the earlier design's causes).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys

from ablation_build import ROOT, prepare, timed

OUT = os.path.join(ROOT, "build", "head_ablation")
REPS = 5
PEAK_BF16, PEAK_FP32, PEAK_HBM = 989e12, 67e12, 3.35e12
# (label, N, H, W, Cin, Cout, lrelu, pad, mask, d2s)
SHAPES_2X2 = [("hr 256->256 pad 1 mask", 4, 536, 536, 256, 256, True, 1,
               True, False),
              ("last 256->12 VALID d2s", 4, 537, 537, 256, 12, False, 0,
               False, True)]
# K1 / K1f shapes held level: (label, N, H, W, Cin, Cout, bias, lrelu, head
# form (d2s, round_first))
LEVEL_K1 = [("w0 64->192", 4, 268, 268, 64, 192, False, False, None),
            ("w2 32->128", 4, 268, 268, 32, 128, False, False, None),
            ("w4 32->64", 4, 268, 268, 32, 64, False, False, None),
            ("conv_body 64->64", 4, 268, 268, 64, 64, True, False, None),
            ("up1 64->256 d2s", 4, 268, 268, 64, 256, True, True,
             (True, True)),
            ("up2 64->256", 4, 536, 536, 64, 256, True, True, (False, True))]
LEVEL_K1F = [("w0 64->192", 4, 268, 268, 64, 192, False, False, False),
             ("up1 64->256 d2s", 4, 268, 268, 64, 256, True, True, True),
             ("up2 64->256", 4, 536, 536, 64, 256, True, True, False)]

# The earlier design: the 2x2 form is K1's implicit GEMM body with KT = 2
# (conv3x3.cu), K1f's with two taps a row (conv3x3_f32.cu).
SHARED_BF16 = {
    # the weight slabs not copied (each slot's barrier completed at once)
    "no_weights": [("    nesr::bulk_load(ring_s + s * S::SLAB * 2, "
                    "p.wp + (size_t)g * S::SLAB,\n"
                    "                    S::SLAB * 2, full_s + 8 * s);",
                    "    nesr::mbar_arrive(full_s + 8 * s);")],
    # the input patch not loaded (its buffer read as it is)
    "no_patch": [("      nesr::cp_async_zfill<VEC * 2>(",
                  "      if (p.Cout < 0) nesr::cp_async_zfill<VEC * 2>(")],
    # the MMAs skipped (loads, barriers and ldmatrix kept)
    "no_mma": [("          nesr::wgmma_rs<N>(acc,",
                "          if (p.Cout < 0) nesr::wgmma_rs<N>(acc,")],
    # the patch staged once a block, not once a pass and N tile
    "no_restage": [("      if (nt == 0 || npass > 1) {",
                    "      if (nt + c == 0) {")],
}
SHARED_F32 = {
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
SHARED = dict(bf16_src="conv3x3.cu", f32_src="conv3x3_f32.cu",
            widths=(16, 64, 128), bf16=SHARED_BF16, f32=SHARED_F32)

# The redesign: kernels of their own, conv2x2.cu and conv2x2_f32.cu.
OWN_BF16 = {
    # the weight slabs not copied (each slot's barrier completed at once)
    "no_weights": [("  W2_LOAD_SLAB(", "  W2_SKIP_SLAB(")],
    # the patch boxes not loaded (each box's barrier completed at once)
    "no_patch": [("  W2_LOAD_BOX(", "  W2_SKIP_BOX(")],
    # the MMAs skipped (loads, barriers and ldmatrix kept)
    "no_mma": [("      W2_MMA;", "      if (p.Cout < 0) W2_MMA;")],
    # the epilogue's global stores skipped (the tile still staged)
    "no_store": [("      if (gy < p.Ho && gx < p.Wo)",
                  "      if (gy < p.Ho && gx < p.Wo && p.Cout < 0)")],
}
# the same edits: the float32 form keeps the earlier loop and staging text
OWN_F32 = SHARED_F32


def _design(csrc: str) -> dict:
    """The tables of the design a csrc directory holds, form by form."""
    des = dict(SHARED)
    if os.path.exists(os.path.join(csrc, "conv2x2.cu")):
        sys.path.insert(0, ROOT)
        from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
            TILE_WIDTHS_2X2)
        des.update(bf16_src="conv2x2.cu", widths=TILE_WIDTHS_2X2,
                   bf16=OWN_BF16)
    if os.path.exists(os.path.join(csrc, "conv2x2_f32.cu")):
        des.update(f32_src="conv2x2_f32.cu", f32=OWN_F32)
    return des


def _ptxas(log: str) -> list[str]:
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "conv" in line:
            out.append(line.split("'")[1] + ": " + " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
    return out


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, nint in (("nesr_conv3x3", 7), ("nesr_conv2x2", 8),
                       ("nesr_conv3x3_f32", 6), ("nesr_conv2x2_f32", 7)):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [vp] * 4 + [ci] * nint + [vp]
            getattr(lib, name).restype = ci


def _bound(taps, n, h, w, cin, cout, pad, nbytes, peak) -> tuple:
    ho, wo = h + 2 * pad - taps + 1, w + 2 * pad - taps + 1
    t_ops = 2.0 * n * ho * wo * cout * taps * taps * cin / peak
    t_bytes = (nbytes * (n * h * w * cin + n * ho * wo * cout
                         + taps * taps * cin * cout) + 4.0 * cout) / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "ops" if t_ops >= t_bytes else "bytes"


def _check(err: int, what: str) -> None:
    if err:
        raise SystemExit(f"{what}: launch failed, CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="the csrc directory to ablate")
    ap.add_argument("--baseline", help="another csrc directory to time")
    ap.add_argument("--only", choices=("bf16", "f32"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("head_ablation: needs a CUDA GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    k1 = importlib.import_module(
        "neural_enhanced_super_resolution_torch.kernels.conv3x3")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    from ablation_build import CSRC
    dirs = {"base": os.path.abspath(args.base) if args.base else CSRC}
    if args.baseline:
        dirs["baseline"] = os.path.abspath(args.baseline)
    designs = {tag: _design(d) for tag, d in dirs.items()}
    kinds = [k for k in ("bf16", "f32") if args.only in (None, k)]
    # builds: (tag, kind) -> {name: (so, proc)}; the level kernels' sources
    # are built unedited for every tag
    jobs = {}
    for tag, d in dirs.items():
        des = designs[tag]
        for kind in kinds:
            src = des[f"{kind}_src"]
            jobs[(tag, kind, tag)] = prepare(OUT, f"{tag}_{kind}", src,
                                             csrc=d, ptxas=True)
            level = "conv3x3.cu" if kind == "bf16" else "conv3x3_f32.cu"
            if level != src:
                jobs[(tag, kind + "_level", tag)] = prepare(
                    OUT, f"{tag}_{kind}_level", level, csrc=d, ptxas=True)
            if tag == "base":
                for name, edits in des[kind].items():
                    jobs[(tag, kind, name)] = prepare(
                        OUT, f"{tag}_{kind}_{name}", src, edits, csrc=d)
    libs = {}
    for key, (so, _, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed\n{log[-3000:]}")
        if key[2] == key[0]:
            for line in _ptxas(log):
                print(f"{key[0]} {key[1]} ptxas {line}", flush=True)
        lib = ctypes.CDLL(so)
        _bind(lib)
        libs[key] = lib
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    turns = (["baseline"] * bool(args.baseline) + ["base"])

    for kind in kinds:
        bf16 = kind == "bf16"
        dt = torch.bfloat16 if bf16 else torch.float32
        variants = list(designs["base"][kind])
        order = turns + variants + turns[::-1]
        for (label, n, h, w, cin, cout, act, pad, mask, d2s) in SHAPES_2X2:
            x = torch.randn((n, h, w, cin), generator=gen).to("cuda", dt)
            wt = (torch.randn((2, 2, cin, cout), generator=gen)
                  * (2.0 / (4 * cin)) ** 0.5).to("cuda", dt)
            b = (torch.randn((cout,), generator=gen) * 0.1).to("cuda")
            ho, wo = h + 2 * pad - 1, w + 2 * pad - 1
            y = torch.empty((n, 2 * ho, 2 * wo, cout // 4) if d2s
                            else (n, ho, wo, cout), device="cuda", dtype=dt)
            flags = (1 if act else 0) | (2 if bf16 else 0) | (
                4 if mask else 0) | (8 if d2s else 0)
            packed = {}
            for tag in turns:
                nw, tiles = k1.tile_width(cout, designs[tag]["widths"])
                packed[tag] = (k1._pack(wt, 64, nw, tiles), nw)

            def run(key):
                lib = libs[(key[0], kind, key[1])]
                if bf16:
                    wp, nw = packed[key[0]]
                    err = lib.nesr_conv2x2(
                        x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                        y.data_ptr(), n, h, w, cin, cout, nw, pad, flags,
                        stream)
                else:
                    err = lib.nesr_conv2x2_f32(
                        x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                        y.data_ptr(), n, h, w, cin, cout, pad, flags, stream)
                _check(err, f"{kind} {label} {key}")

            times = []
            for name in order:
                key = (name, name) if name in dirs else ("base", name)
                times.append((name, timed(torch, lambda: run(key), REPS)))
            xc = x.permute(0, 3, 1, 2)
            wc = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = b.to(dt)
            times.append(("cuDNN", timed(
                torch, lambda: F.conv2d(xc, wc, bc, padding=pad), REPS)))
            times.append(("plain", timed(
                torch, lambda: k1.conv2x2_s2d_plain(x, wt, b, act, pad, mask,
                                                    d2s), 2)))
            bms, by = _bound(2, n, h, w, cin, cout, pad, 2 if bf16 else 4,
                             PEAK_BF16 if bf16 else PEAK_FP32)
            print(f"{kind} 2x2 {label} on {(n, h, w, cin)}: bound {bms:.4f} "
                  f"ms ({by}); " + ", ".join(
                      f"{name} {ms:.4f}" for name, ms in times)
                  + " ms a launch", flush=True)
            del x, y, xc
            torch.cuda.empty_cache()

        # K1's / K1f's 3x3 forms, held level with the baseline's
        level = LEVEL_K1 if bf16 else LEVEL_K1F
        for (label, n, h, w, cin, cout, bias, act, head) in level:
            x = torch.randn((n, h, w, cin), generator=gen).to("cuda", dt)
            wt = (torch.randn((3, 3, cin, cout), generator=gen)
                  * (2.0 / (9 * cin)) ** 0.5).to("cuda", dt)
            b = ((torch.randn((cout,), generator=gen) * 0.1).to("cuda")
                 if bias else None)
            if bf16:
                d2s, first = head or (False, False)
                is_head = head is not None
            else:
                d2s, first, is_head = bool(head), False, False
            y = torch.empty((n, 2 * h, 2 * w, cout // 4) if d2s
                            else (n, h, w, cout), device="cuda", dtype=dt)
            flags = (1 if act else 0) | (2 if first else 0) | (
                8 if d2s else 0)
            if bf16:
                wp = k1.pack_conv3x3_weights(wt, head=is_head)
                nw = (k1.tile_width(cout, (16, 64, 128)) if is_head
                      else k1.tile_width(cout))[0]

            def run3(tag):
                key = (tag, kind + "_level", tag)
                lib = libs[key] if key in libs else libs[(tag, kind, tag)]
                bp = b.data_ptr() if b is not None else None
                if bf16:
                    err = lib.nesr_conv3x3(x.data_ptr(), wp.data_ptr(), bp,
                                           y.data_ptr(), n, h, w, cin, cout,
                                           nw, flags, stream)
                else:
                    err = lib.nesr_conv3x3_f32(x.data_ptr(), wt.data_ptr(),
                                               bp, y.data_ptr(), n, h, w,
                                               cin, cout, flags, stream)
                _check(err, f"{kind} level {label} {tag}")

            times = [(tag, timed(torch, lambda: run3(tag), REPS))
                     for tag in turns + turns[::-1]]
            print(f"{'K1' if bf16 else 'K1f'} level {label} on "
                  f"{(n, h, w, cin)}: " + ", ".join(
                      f"{tag} {ms:.4f}" for tag, ms in times)
                  + " ms a launch", flush=True)
            del x, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
