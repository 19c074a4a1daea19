"""Where the folded head's forms spend their time: K1's (bf16) and K1f's
(float32) 3x3 forms at up1 and up2 and 2x2 forms at hr and last, each
against copies of itself with one part taken out and, optionally, against
another ``csrc``, on one CUDA GPU.

    python3 tools/head_ablation.py [--base CSRC_DIR] [--baseline CSRC_DIR]
                                   [--only bf16|f32] [--form 3x3|2x2]

The shapes are the folded head's on the 4 x 268^2 tile batch: up1, 4 x
268^2 x 64 -> 256 stored depth-to-space; up2, 4 x 536^2 x 64 -> 256; hr,
4 x 536^2 x 256 -> 256 at padding 1 with the frame mask; last, 4 x 537^2 x
256 -> 12 VALID, stored depth-to-space; all with the JAX package's
rounding. Each build's source is copied into ``build/head_ablation/<build>/``,
the variants' copies edited as their design's table lists (textual edits;
one whose text no longer matches fails loudly), and every copy is built
by its own nvcc, all at once; the ptxas report (registers, spills) of each
unedited build is printed. The variants compute wrong outputs on purpose;
only their times mean anything.

Which tables apply is read from the csrc directory: the earlier 3x3
forms ran in ``conv3x3.cu`` (K1's SAME-conv body with the head's epilogue)
and ``conv3x3_f32.cu``; the redesign has them in ``conv3x3_head.cu`` and
``conv3x3_head_f32.cu``, beside the 2x2 forms' ``conv2x2.cu`` and
``conv2x2_f32.cu``. ``--baseline`` (e.g. a ``git archive`` of the parent
commit under ``outputs/``) times that directory's unedited forms in turns
with this one's (baseline, base, variants, base, baseline), and in the
same turns K1's SAME conv at trunk w0 / w2 / w4 and conv_body and K1f's at
trunk w0, which the redesign must leave level.

Each time is CUDA events over REPS launches after a warm-up, printed
beside the bound (989 TFLOP/s bf16, 67 TFLOP/s float32, 3.35 TB/s), cuDNN's
conv at the same shape and padding (bf16, or float32 with TF32 off) and
the plain version. Prints the card (name, power limit) first. ``--base``
ablates another csrc than the package's (an earlier commit's, to read the
earlier design's causes).
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
# (label, taps, N, H, W, Cin, Cout, lrelu, pad, mask, d2s)
SHAPES = {"3x3": [("up1 64->256 d2s", 3, 4, 268, 268, 64, 256, True, 1,
                   False, True),
                  ("up2 64->256", 3, 4, 536, 536, 64, 256, True, 1, False,
                   False)],
          "2x2": [("hr 256->256 pad 1 mask", 2, 4, 536, 536, 256, 256, True,
                   1, True, False),
                  ("last 256->12 VALID d2s", 2, 4, 537, 537, 256, 12, False,
                   0, False, True)]}
# K1's / K1f's SAME conv, held level with the baseline's: (label, N, H,
# W, Cin, Cout, bias)
LEVEL_K1 = [("w0 64->192", 4, 268, 268, 64, 192, False),
            ("w2 32->128", 4, 268, 268, 32, 128, False),
            ("w4 32->64", 4, 268, 268, 32, 64, False),
            ("conv_body 64->64", 4, 268, 268, 64, 64, True)]
LEVEL_K1F = [("w0 64->192", 4, 268, 268, 64, 192, False)]

# K1f's loop and staging text, which its forms share.
F32_LOOP = {
    # no FMAs: the staging and the barriers alone
    "no_fma": [("    for (int q = 0; q < nq; ++q) {",
                "    for (int q = 0; q < (a.Cin < 0 ? nq : 0); ++q) {")],
    # pass 0 staged, the later passes compute on it without copies or waits
    "no_staging": [("    if (p + 1 < passes) issue(p + 1);",
                    "    if (p + 1 < passes && p < 1) issue(p + 1);"),
                   ("    nesr::mbar_wait(bar0 + 8 * (p & 1), (p >> 1) & 1);",
                    "    if (p < 2) nesr::mbar_wait(bar0 + 8 * (p & 1), "
                    "(p >> 1) & 1);")],
    # the weights not copied (the stage's barrier arrived on at once)
    "no_weights": [("      if (tid == 0) nesr::mbar_expect_tx(bar, "
                    "(uint32_t)(runs * bytes));\n      if (tid < 32) {",
                    "      if (tid == 0) nesr::mbar_arrive(bar);\n"
                    "      if (tid < 0) {")],
    # the patch not copied (its buffer read as it is)
    "no_patch": [("        nesr::cp_async_zfill<16>(sx + py * PRS + px * CC "
                  "+ 4 * q, src,",
                  "        if (a.Cin < 0) nesr::cp_async_zfill<16>(sx + py * "
                  "PRS + px * CC + 4 * q, src,")],
}

# The earlier 3x3 forms: K1's SAME-conv body (conv3x3_body.cuh) with the
# head's epilogue in conv3x3.cu; K1f's body in conv3x3_f32.cu.
EARLY_3X3_BF16 = {
    # the weight slabs not copied (each slot's barrier completed at once)
    "no_weights": [("    nesr::bulk_load(ring_s + s * S::SLAB * 2, "
                    "p.wp + (size_t)g * S::SLAB,\n"
                    "                    S::SLAB * 2, full_s + 8 * s);",
                    "    nesr::mbar_arrive(full_s + 8 * s);")],
    # the input patch not loaded (its buffer read as it is)
    "no_patch": [("      nesr::cp_async_zfill<VEC * 2>(",
                  "      if (p.Cout < 0) nesr::cp_async_zfill<VEC * 2>(")],
    # the MMAs skipped (loads, barriers and ldmatrix kept)
    "no_mma": [("    nesr::wgmma_rs<N>(acc, a[kk],",
                "    if (bs == 1u) nesr::wgmma_rs<N>(acc, a[kk],")],
    # the global stores skipped (the tile still staged): the depth-to-space
    # path (up1) and the NHWC one (up2)
    "no_store": [("        if (gy < p.Ho && gx < p.Wo)\n"
                  "          *reinterpret_cast<uint4*>(p.y + out_index(",
                  "        if (gy < p.Ho && gx < p.Wo && p.Cout < 0)\n"
                  "          *reinterpret_cast<uint4*>(p.y + out_index("),
                 ("          if (gy < p.Ho && gx < p.Wo)\n"
                  "            *reinterpret_cast<uint4*>(y + ",
                  "          if (gy < p.Ho && gx < p.Wo && p.Cout < 0)\n"
                  "            *reinterpret_cast<uint4*>(y + ")],
}
EARLY_3X3_F32 = dict(F32_LOOP, no_store=[
    ("    if (ox >= a.Wo) break;", "    if (ox >= a.Wo || a.Cin > 0) break;")])

# The redesign: conv3x3_head.cu (persistent, producer warp, resident
# weights) and conv3x3_head_f32.cu.
OWN_3X3_BF16 = {
    # the N tile's weights not loaded (their barrier arrived on at once)
    "no_weights": [("  nesr::mbar_expect_tx(wfull_s, p.npass * 9 * SLAB * 2);\n"
                    "  H3_LOAD_WEIGHTS;",
                    "  nesr::mbar_arrive(wfull_s);")],
    # the patch boxes not loaded (each slot's barrier arrived on at once)
    "no_patch": [("        H3_LOAD_BOX(s, pc);",
                  "        nesr::mbar_arrive(full_s + 8 * (s));")],
    # the MMAs skipped (barriers, turns and ldmatrix kept)
    "no_mma": [("        H3_MMA_TAP(t);", "        if (p.H < 0) H3_MMA_TAP(t);")],
    # the output boxes not stored (the tile still staged)
    "no_store": [("  if (p.tma_out) {\n    if (ct == 0) {",
                  "  if (p.tma_out) {\n    if (ct == 0 && p.H < 0) {")],
    # the consumers not taking turns at the tensor cores
    "unordered": [("    if (c == 1 || i > 0) named_sync(",
                   "    if (p.H < 0) named_sync("),
                  ("    if (c ? it0 > i + 1 : it1 > i) named_arrive(",
                   "    if (p.H < 0) named_arrive(")],
}
# Designs tried beside it (the same outputs): three sets of A fragments,
# two taps' MMAs in flight while the third loads; the partner's turn given
# before the last tap's MMAs have retired, so its first MMAs queue behind
# them.
TRIPLE_A = [("  uint32_t a[2][4][4];", "  uint32_t a[3][4][4];"),
            ("a[(t) & 1]", "a[(t) % 3]"),
            ("        if (t > 0) nesr::wgmma_wait<1>();",
             "        if (t > 1) nesr::wgmma_wait<2>();")]
EARLY_TURN = [("      nesr::wgmma_wait<0>();\n      // The slot back",
               "      if (pc == p.npass - 1 && (c ? it0 > i + 1 : it1 > i))\n"
               "        named_arrive(c ? HORD0 : HORD1, 256);\n"
               "      nesr::wgmma_wait<0>();\n      // The slot back"),
              ("    if (c ? it0 > i + 1 : it1 > i) named_arrive(c ? HORD0 : "
               "HORD1, 256);\n", "")]
# A probe, not a design: the same slabs read through a 128-byte-swizzle
# descriptor (wrong outputs), to time the MMAs with B in that layout.
PROBE_B_SW128 = [("nesr::wgmma_desc(bs + kk * 32 * N, 128,\n"
                  "                                                   256)",
                  "(nesr::wgmma_desc(bs + kk * 32, 16, 1024) | (1ull << 62))")]
OWN_3X3_BF16.update({"probe_b_sw128": PROBE_B_SW128,
                     "design_triple_a": TRIPLE_A,
                     "design_early_turn": EARLY_TURN,
                     "design_triple_a_early_turn": TRIPLE_A + EARLY_TURN})
OWN_3X3_F32 = dict(F32_LOOP, no_store=[
    ("    if (ox >= W) break;", "    if (ox >= W || a.Cin > 0) break;")])

# The 2x2 forms, kernels of their own (conv2x2.cu, conv2x2_f32.cu).
OWN_2X2_BF16 = {
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
OWN_2X2_F32 = {k: F32_LOOP[k] for k in ("no_fma", "no_staging")}


def _design(csrc: str) -> dict:
    """(kind, form) -> (source, headers, edits, entry point) of the design
    a csrc directory holds."""
    has = lambda f: os.path.exists(os.path.join(csrc, f))   # noqa: E731
    des = {("bf16", "2x2"): ("conv2x2.cu", (), OWN_2X2_BF16, "conv2x2"),
           ("f32", "2x2"): ("conv2x2_f32.cu", (), OWN_2X2_F32, "conv2x2_f32")}
    if has("conv3x3_head.cu"):
        des["bf16", "3x3"] = ("conv3x3_head.cu", ("conv3x3_body.cuh",),
                              OWN_3X3_BF16, "conv3x3_head")
    else:
        des["bf16", "3x3"] = ("conv3x3.cu", ("conv3x3_body.cuh",),
                              EARLY_3X3_BF16, "conv3x3")
    if has("conv3x3_head_f32.cu"):
        des["f32", "3x3"] = ("conv3x3_head_f32.cu", (), OWN_3X3_F32,
                             "conv3x3_head_f32")
    else:
        des["f32", "3x3"] = ("conv3x3_f32.cu", (), EARLY_3X3_F32,
                             "conv3x3_f32")
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
                       ("nesr_conv3x3_head", 9), ("nesr_conv3x3_f32", 6),
                       ("nesr_conv2x2_f32", 7), ("nesr_conv3x3_head_f32", 6)):
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
    ap.add_argument("--form", choices=("3x3", "2x2"))
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from ablation_build import CSRC
    dirs = {"base": os.path.abspath(args.base) if args.base else CSRC}
    if args.baseline:
        dirs["baseline"] = os.path.abspath(args.baseline)
    designs = {tag: _design(d) for tag, d in dirs.items()}
    kinds = [k for k in ("bf16", "f32") if args.only in (None, k)]
    forms = [f for f in ("3x3", "2x2") if args.form in (None, f)]
    # builds: (tag, kind, form or "level", variant) -> (so, proc); every
    # tag's forms and its SAME convs (the level) built unedited
    jobs = {}
    for tag, d in dirs.items():
        for kind in kinds:
            level = "conv3x3.cu" if kind == "bf16" else "conv3x3_f32.cu"
            jobs[(tag, kind, "level", tag)] = prepare(
                OUT, f"{tag}_{kind}_level", level, csrc=d, ptxas=True)
            for form in forms:
                src, headers, edits, _ = designs[tag][kind, form]
                jobs[(tag, kind, form, tag)] = prepare(
                    OUT, f"{tag}_{kind}_{form}", src, csrc=d, ptxas=True)
                if tag != "base":
                    continue
                for name, ed in edits.items():
                    jobs[(tag, kind, form, name)] = prepare(
                        OUT, f"{tag}_{kind}_{form}_{name}", src, ed,
                        csrc=d, headers=headers)
    libs = {}
    for key, (so, _, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed\n{log[-3000:]}")
        if key[3] == key[0]:
            for line in _ptxas(log):
                print(f"{key[0]} {key[1]} {key[2]} ptxas {line}", flush=True)
        lib = ctypes.CDLL(so)
        _bind(lib)
        libs[key] = lib
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    turns = ["baseline"] * bool(args.baseline) + ["base"]

    for kind in kinds:
        bf16 = kind == "bf16"
        dt = torch.bfloat16 if bf16 else torch.float32
        for form in forms:
            variants = list(designs["base"][kind, form][2])
            order = turns + variants + turns[::-1]
            for (label, taps, n, h, w, cin, cout, act, pad, mask,
                 d2s) in SHAPES[form]:
                x = torch.randn((n, h, w, cin), generator=gen).to("cuda", dt)
                wt = (torch.randn((taps, taps, cin, cout), generator=gen)
                      * (2.0 / (taps * taps * cin)) ** 0.5).to("cuda", dt)
                b = (torch.randn((cout,), generator=gen) * 0.1).to("cuda")
                ho, wo = h + 2 * pad - taps + 1, w + 2 * pad - taps + 1
                y = torch.empty((n, 2 * ho, 2 * wo, cout // 4) if d2s
                                else (n, ho, wo, cout), device="cuda",
                                dtype=dt)
                flags = (1 if act else 0) | (2 if bf16 else 0) | (
                    4 if mask else 0) | (8 if d2s else 0)
                if taps == 3:
                    wp = k1.pack_conv3x3_weights(wt, head=True)
                    nw = k1.head_tile_width(cin, cout)[0]
                    plan = k1.head_plan(n, h, w, cin, cout, sms)
                else:
                    wp = k1.pack_conv2x2_weights(wt)
                    nw = k1.tile_width_2x2(cout)[0]

                def run(key, wp=wp, nw=nw):
                    tag, name = key
                    entry = designs[tag][kind, form][3]
                    lib = libs[(tag, kind, form, name)]
                    ptrs = (x.data_ptr(), wp.data_ptr() if bf16
                            else wt.data_ptr(), b.data_ptr(), y.data_ptr())
                    dims = (n, h, w, cin, cout)
                    if entry == "conv3x3_head":
                        err = lib.nesr_conv3x3_head(
                            *ptrs, *dims, nw, flags, plan["grid"],
                            plan["smem"], stream)
                    elif entry == "conv3x3":
                        err = lib.nesr_conv3x3(*ptrs, *dims, nw, flags,
                                               stream)
                    elif entry == "conv2x2":
                        err = lib.nesr_conv2x2(*ptrs, *dims, nw, pad, flags,
                                               stream)
                    elif entry == "conv2x2_f32":
                        err = lib.nesr_conv2x2_f32(*ptrs, *dims, pad, flags,
                                                   stream)
                    else:
                        err = getattr(lib, f"nesr_{entry}")(*ptrs, *dims,
                                                            flags, stream)
                    _check(err, f"{kind} {form} {label} {key}")

                times = []
                for name in order:
                    key = (name, name) if name in dirs else ("base", name)
                    times.append((name, timed(torch, lambda: run(key),
                                              REPS)))
                xc = x.permute(0, 3, 1, 2)
                wc = wt.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bc = b.to(dt)
                times.append(("cuDNN", timed(
                    torch, lambda: F.conv2d(xc, wc, bc, padding=pad), REPS)))
                if taps == 3:
                    plain = lambda: k1.conv3x3_plain(x, wt, b, act, d2s,
                                                     bf16)
                else:
                    plain = lambda: k1.conv2x2_s2d_plain(x, wt, b, act, pad,
                                                         mask, d2s)
                times.append(("plain", timed(torch, plain, 2)))
                bms, by = _bound(taps, n, h, w, cin, cout, pad,
                                 2 if bf16 else 4,
                                 PEAK_BF16 if bf16 else PEAK_FP32)
                print(f"{kind} {form} {label} on {(n, h, w, cin)}: bound "
                      f"{bms:.4f} ms ({by}); " + ", ".join(
                          f"{name} {ms:.4f}" for name, ms in times)
                      + " ms a launch", flush=True)
                del x, y, xc
                torch.cuda.empty_cache()

        # K1's / K1f's SAME conv, held level with the baseline's
        for (label, n, h, w, cin, cout, bias) in (LEVEL_K1 if bf16
                                                   else LEVEL_K1F):
            x = torch.randn((n, h, w, cin), generator=gen).to("cuda", dt)
            wt = (torch.randn((3, 3, cin, cout), generator=gen)
                  * (2.0 / (9 * cin)) ** 0.5).to("cuda", dt)
            b = ((torch.randn((cout,), generator=gen) * 0.1).to("cuda")
                 if bias else None)
            y = torch.empty((n, h, w, cout), device="cuda", dtype=dt)
            wp = k1.pack_conv3x3_weights(wt) if bf16 else wt

            def run3(tag):
                lib = libs[(tag, kind, "level", tag)]
                bp = b.data_ptr() if b is not None else None
                if bf16:
                    err = lib.nesr_conv3x3(x.data_ptr(), wp.data_ptr(), bp,
                                           y.data_ptr(), n, h, w, cin, cout,
                                           k1.tile_width(cout)[0], 0, stream)
                else:
                    err = lib.nesr_conv3x3_f32(x.data_ptr(), wt.data_ptr(),
                                               bp, y.data_ptr(), n, h, w,
                                               cin, cout, 0, stream)
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
