"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``csrc/``, holds each one
against its plain PyTorch version at the shapes the ESRGAN path gives it,
runs the full-width 12-channel RRDBNet x4 (64 features, 23 blocks, growth
32; seeded synthetic weights) on a 4-tile batch with both trunks, then
drives the product path (the CLI in a subprocess and ``enhance_image`` in
process) and checks that it went through the kernels. Prints the card,
every measurement, a JSON line of per-kernel results and, last, a JSON
status line. Any failure exits non-zero without the status line. Needs no
JAX and no network; writes only under ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
PKG = "neural_enhanced_super_resolution_torch"
ARCH = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64, num_block=23,
            num_grow_ch=32)
TILE_BATCH = (4, 268, 268)   # 4 tiles of 256 + 2 * 6 halo (cuda overlay)
TOL_KERNEL = 1e-2            # max|err| / max(1, max|ref|), per kernel
TOL_FORWARD = 3e-2           # the same for the full forward
SEED = 0


def log(*args):
    print(*args, flush=True)


def rel_err(got, ref) -> tuple[float, float]:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


def cuda_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def build_kernels() -> None:
    from neural_enhanced_super_resolution_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build+load: {time.perf_counter() - t0:.3f} s "
        f"(nvcc sm_90a, {_build.build_dir()})")


def _rnd(torch, gen, *shape, scale=1.0, dtype=None):
    return (torch.randn(*shape, generator=gen) * scale).to(
        "cuda", dtype or torch.bfloat16).contiguous()


def check_conv3x3(torch, gen) -> dict:
    """K1 at every conv shape of the path, against conv3x3_plain."""
    import torch.nn.functional as F
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3, conv3x3_plain)

    n, h, w = TILE_BATCH
    result = {}
    # (label, N, H, W, Cin, Cout, bias, lrelu): conv_first, the fused
    # trunk's widest and narrowest convs, conv_body, the head at 2x and
    # 4x, conv_last.
    shapes = [("conv_first 12->64", n, h, w, 12, 64, True, False),
              ("trunk w0 64->192", n, h, w, 64, 192, False, False),
              ("trunk w4 32->64", n, h, w, 32, 64, False, False),
              ("conv_body 64->64", n, h, w, 64, 64, True, False),
              ("conv_up1 2x 64->64", n, 2 * h, 2 * w, 64, 64, True, True),
              ("conv_up2 4x 64->64", n, 4 * h, 4 * w, 64, 64, True, True),
              ("conv_last 4x 64->3", n, 4 * h, 4 * w, 64, 3, True, False)]
    k1_err = 0.0
    for label, nn_, hh, ww, cin, cout, bias, act in shapes:
        x = _rnd(torch, gen, nn_, hh, ww, cin)
        wt = _rnd(torch, gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = (_rnd(torch, gen, cout, scale=0.1, dtype=torch.float32)
             if bias else None)
        got = conv3x3(x, wt, b, act)
        ref = conv3x3_plain(x, wt, b, act)
        d, r = rel_err(got, ref)
        ms = cuda_ms(lambda: conv3x3(x, wt, b, act))
        pms = cuda_ms(lambda: conv3x3_plain(x, wt, b, act))
        # For scale only: the library's bf16 conv (cuDNN, channels_last).
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.to(torch.bfloat16) if bias else None
        cms = cuda_ms(lambda: F.conv2d(xc, wc, bc, padding=1))
        log(f"K1 conv3x3 {label} {tuple(x.shape)}: max_abs_err {d:.6g} "
            f"rel {r:.3g} (tol {TOL_KERNEL}) kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms (cuDNN bf16 conv {cms:.4f} ms)")
        if not r <= TOL_KERNEL:
            raise AssertionError(f"K1 {label}: rel err {r} > {TOL_KERNEL}")
        k1_err = max(k1_err, d)
        if label.startswith("trunk w0"):
            result = {"ms": ms, "plain_ms": pms}
        del x, got, ref
    result["max_abs_err"] = k1_err
    return result


def check_rdb_fused(torch, gen) -> dict:
    """K2 on a tile batch against rdb_fused_plain.

    The weights (std 0.05, bias std 0.1) are large enough that each conv
    of the dense chain moves the output by more than the bar: a kernel
    that drops one stage's conv or one slot add fails. At the trained-like
    scale of init_rrdbnet (0.1 x Kaiming) the whole dense branch would sit
    under the bar and such a kernel would pass. The error is also printed
    against the size of the residual branch 0.2 * x5 alone.
    """
    from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
        rdb_fused, rdb_fused_plain)

    n, h, w = TILE_BATCH
    x = _rnd(torch, gen, n, h, w, 64, scale=0.5)
    ws = [_rnd(torch, gen, 3, 3, cin, cout, scale=0.05)
          for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96),
                            (32, 64))]
    bb = _rnd(torch, gen, 192, scale=0.1, dtype=torch.float32)
    ref = rdb_fused_plain(x, ws, bb)
    d, r = rel_err(rdb_fused(x, ws, bb), ref)
    branch = (ref.float() - x.float()).abs().max().item()
    ms = cuda_ms(lambda: rdb_fused(x, ws, bb))
    pms = cuda_ms(lambda: rdb_fused_plain(x, ws, bb))
    log(f"K2 rdb_fused {tuple(x.shape)}: max_abs_err {d:.6g} rel {r:.3g} "
        f"(tol {TOL_KERNEL}; max|ref| {ref.float().abs().max().item():.4g},"
        f" max|0.2*x5| {branch:.4g}, err/branch {d / branch:.3g}) "
        f"kernel {ms:.4f} ms plain {pms:.4f} ms")
    if not r <= TOL_KERNEL:
        raise AssertionError(f"K2: rel err {r} > {TOL_KERNEL}")
    return {"ms": ms, "plain_ms": pms, "max_abs_err": d}


def check_forward(torch, gen, sd, name: str) -> None:
    """Both trunks' full-width forward against the plain trunk.

    At init_rrdbnet's scale each RDB's dense branch is a few percent of its
    output, so this holds the model's wiring (head, trunk order, weights),
    not each RDB's dense chain: a K2 that drops one conv passes here and
    fails check_rdb_fused.
    """
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig)

    cfg = RRDBNetConfig(**ARCH)
    n, h, w = TILE_BATCH
    x = torch.rand((n, h, w, 12), generator=gen).to("cuda")
    mp_out = n * (4 * h) * (4 * w) / 1e6
    ref = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")(x, plain=True)
    torch.cuda.empty_cache()
    for trunk in ("fused", "dform"):
        model = RRDBNet(cfg, sd, torch.bfloat16, "cuda", trunk)
        out = model(x)
        d, r = rel_err(out, ref)
        ms = cuda_ms(lambda: model(x), reps=3)
        log(f"forward {trunk} trunk ({'K1' if trunk == 'fused' else 'K2+K1'})"
            f" 12ch x4 nf64 nb23 gc32 on {tuple(x.shape)}: max_abs_err "
            f"{d:.6g} rel {r:.3g} vs plain trunk (tol {TOL_FORWARD}); "
            f"{ms:.2f} ms/batch = {mp_out / (ms / 1e3):.3f} MP_out/s "
            f"(output incl. halo) on {name}")
        if not (r <= TOL_FORWARD and torch.isfinite(out).all()):
            raise AssertionError(f"forward {trunk}: rel err {r}")
        del model, out
    plain = RRDBNet(cfg, sd, torch.bfloat16, "cuda", "fused")
    pms = cuda_ms(lambda: plain(x, plain=True), reps=1)
    log(f"forward plain trunk: {pms:.2f} ms/batch = "
        f"{mp_out / (pms / 1e3):.3f} MP_out/s on {name}")


def drive_product_path(torch, np, ckpt: str) -> dict:
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        conv3x3, conv3x3_plain)
    from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
        rdb_fused, rdb_fused_plain)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "esrgan_model_path": ckpt,
            "output_dir": os.path.join(OUT, "out")}
    rng = np.random.default_rng(SEED)
    inputs = {}
    for label, (hh, ww) in (("seeded_512x384", (384, 512)),
                            ("odd_301x257", (257, 301)),
                            ("small_96", (96, 96))):
        # smooth random content: upsampled noise, so ESRGAN sees structure
        small = rng.integers(0, 256, (hh // 8 + 1, ww // 8 + 1, 3),
                             dtype=np.uint8)
        img = np.kron(small, np.ones((8, 8, 1), np.uint8))[:hh, :ww]
        path = os.path.join(OUT, f"{label}.png")
        imwrite_rgb(path, img)
        inputs[label] = path
    fixture = os.path.join(ROOT, "tests", "fixtures", "test.jpeg")

    cli_cfg = os.path.join(OUT, "cli_config.json")
    with open(cli_cfg, "w") as f:
        json.dump(base, f)
    cli_out = os.path.join(OUT, "cli", "result.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--cli", "-i", fixture, "-c", cli_cfg,
         "-n", "1", "-o", cli_out, "-d", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    log(f"CLI subprocess: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError("CLI failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    got = imread_rgb(cli_out)
    if got.shape != (640, 640, 3) or got.std() == 0:
        raise AssertionError(f"CLI output {got.shape} std {got.std()}")

    requests = [("K1 trunk", fixture, 1, None),
                ("K1 trunk", inputs["seeded_512x384"], 1, None),
                ("K2 trunk", inputs["odd_301x257"], 1, "dform"),
                ("K2 trunk", inputs["small_96"], 2, "dform")]
    pipes = {trunk: SuperResolutionPipeline(
        device="cuda", config=dict(base, esrgan_trunk=trunk))
        for trunk in (None, "dform")}
    for p in pipes.values():
        p._load_models()   # set-up: weights to the card before the window
        if "esrgan" not in p.models:
            raise AssertionError("ESRGAN did not load")

    conv3x3.launches = rdb_fused.launches = 0
    conv3x3_plain.calls = rdb_fused_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for label, path, iters, trunk in requests:
        pipe = pipes[trunk]
        pipe.config["iterations"] = iters
        t1 = time.perf_counter()
        out_path = pipe.enhance_image(path)
        dt = time.perf_counter() - t1
        src, out = imread_rgb(path), imread_rgb(out_path)
        want = (src.shape[0] * 4 ** iters, src.shape[1] * 4 ** iters, 3)
        log(f"request {os.path.basename(path)} -n {iters} ({label}): "
            f"{src.shape[:2]} -> {out.shape[:2]} in {dt:.3f} s; "
            f"output {os.path.basename(out_path)}")
        if out.shape != want or out.std() == 0:
            raise AssertionError(f"{path}: output {out.shape} (want {want}),"
                                 f" std {out.std()}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"conv3x3": conv3x3.launches, "rdb_fused": rdb_fused.launches,
              "conv3x3_plain": conv3x3_plain.calls,
              "rdb_fused_plain": rdb_fused_plain.calls}
    log(f"product path: {len(requests)} requests in {wall:.3f} s; "
        f"counts {counts}")
    if counts["conv3x3"] == 0 or counts["rdb_fused"] == 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    if counts["conv3x3_plain"] or counts["rdb_fused_plain"]:
        raise AssertionError(f"plain versions ran on the card: {counts}")
    for trunk, p in pipes.items():
        log(f"StageTimer ({trunk or 'fused'} trunk pipeline):")
        for line in p.timer.summary_lines():
            log(line)
    return counts


def check_against_cpu(torch, np, ckpt: str) -> None:
    """The product path on a small input agrees with the same path on the
    CPU in float32 (plain versions): PSNR of the uint8 outputs."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "esrgan_model_path": ckpt, "iterations": 1,
            "output_dir": os.path.join(OUT, "ref")}
    rng = np.random.default_rng(SEED + 1)
    img = np.kron(rng.integers(0, 256, (7, 7, 3), dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    ref = SuperResolutionPipeline("cpu", base).enhance_array(img).astype(
        np.float64)
    for trunk in (None, "dform"):
        got = SuperResolutionPipeline("cuda", dict(base, esrgan_trunk=trunk)
                                      ).enhance_array(img).astype(np.float64)
        mse = float(np.mean((got - ref) ** 2))
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        log(f"small input 56x56 ({trunk or 'fused'} trunk, bf16 card) vs CPU "
            f"float32 plain: PSNR {psnr:.2f} dB, max diff "
            f"{np.abs(got - ref).max():.0f} (bar 30 dB)")
        if got.shape != ref.shape or not psnr >= 30.0:
            raise AssertionError(f"small-input agreement: PSNR {psnr}")


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch
        import neural_enhanced_super_resolution_torch as pkg
        from neural_enhanced_super_resolution_torch.models import (
            RRDBNetConfig, init_rrdbnet, save_state_dict)
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.join(ROOT, PKG) + os.sep):
        print(f"chip_smoke: imported {PKG} from {pkg.__file__}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 3
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    os.makedirs(OUT, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    name = f"{card} (nvidia-smi name, power.limit)"
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"CUDA {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    gen = torch.Generator().manual_seed(SEED)
    t_start = time.perf_counter()

    build_kernels()
    results = {"conv3x3": check_conv3x3(torch, gen),
               "rdb_fused": check_rdb_fused(torch, gen)}
    sd = init_rrdbnet(RRDBNetConfig(**ARCH), torch.Generator().manual_seed(
        SEED))
    check_forward(torch, gen, sd, name)
    ckpt = save_state_dict(sd, os.path.join(OUT, "synthetic_x4_12ch.pth"))
    counts = drive_product_path(torch, np, ckpt)
    check_against_cpu(torch, np, ckpt)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    sources = {"conv3x3": "csrc/conv3x3.cu", "rdb_fused": "csrc/rdb_fused.cu"}
    # K1 also carries the math of kernels/conv3x3.py:106 and
    # kernels/conv3x3_v2.py:103; rows_s2d_conv3x3 is the one whose shapes
    # the default trunk runs.
    replaces = {
        "conv3x3": "neural_enhanced_super_resolution_tpu/kernels/"
                   "rdb_pallas.py:190",
        "rdb_fused": "neural_enhanced_super_resolution_tpu/kernels/"
                     "rdb_dform.py:575"}
    kernels = [{"name": k, "route": "cuda",
                "source": f"{PKG}/{sources[k]}", "replaces": replaces[k],
                "launches": counts[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in ("conv3x3", "rdb_fused")]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
