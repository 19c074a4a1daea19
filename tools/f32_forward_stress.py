"""Whether the float32 forward on the RDB step gives the same bits every
time, on one CUDA GPU: the full-width RRDBNet x4 (chip_smoke.ARCH) on the
4 x 268^2 tile batch, under the conditions a rare fault would need.

    python3 tools/f32_forward_stress.py [--seeds N] [--reps R]

For each of N seeded inputs: the plain forward (cuDNN's float32 convs,
TF32 off) once, then R forwards on the kernels, each held against the
first bit for bit and against the plain forward (chip_smoke's bar, rel
1e-4 of max(1, max|ref|)):
  * plain: one after another;
  * busy: with float32 matmuls queued on a second stream, so other work
    shares the SMs while the forward runs;
  * poisoned: after every cached free block of the allocator was filled
    with NaN (a read of memory no kernel wrote brings NaN in);
  * margined: every CUDA ``torch.empty`` / ``empty_like`` of the forward
    (the RDBs' slots and x_k buffers, each kernel's output) inside a
    NaN-filled buffer with MARGIN floats before and after; after each
    launch of K1f, its head forms and the float32 RDB step, every live
    buffer's margins must still be NaN (an out-of-bounds write shows);
  * held: each of the 69 RDBs against FusedRDB._composition (five K1f
    convs and the assembly in PyTorch) on its own input, bit for bit.
Prints the card (name, power limit) first and one line a seed; exits 1 if
any forward differs from the first, misses the bar, is not finite, or a
margin was written.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1 << 16
PKG = "neural_enhanced_super_resolution_torch"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2,
                    help="forwards a condition and seed")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, init_rrdbnet)
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    if not torch.cuda.is_available():
        print("f32_forward_stress: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = RRDBNetConfig(**cs.ARCH)
    model = RRDBNet(cfg, init_rrdbnet(cfg, torch.Generator().manual_seed(
        cs.SEED)), torch.float32, "cuda", "fused")
    k1 = sys.modules[f"{PKG}.kernels.conv3x3"]
    kr = sys.modules[f"{PKG}.kernels.conv3x3_rdb"]
    n, h, w = cs.TILE_BATCH
    side = torch.cuda.Stream()
    big = torch.randn(8192, 8192, device="cuda")
    real_empty, real_empty_like = torch.empty, torch.empty_like
    live: list = []
    margin_writes: list = []

    def margined(shape, dtype, device):
        numel = math.prod(shape)
        buf = real_empty(numel + 2 * MARGIN, dtype=dtype, device=device)
        buf.fill_(float("nan"))
        t = buf[MARGIN:MARGIN + numel].view(shape)
        live.append((weakref.ref(t), numel))
        return t

    def empty(*size, dtype=None, device=None, **kw):
        shape = (tuple(size[0]) if len(size) == 1 and isinstance(
            size[0], (tuple, list, torch.Size)) else size)
        dt = dtype or torch.get_default_dtype()
        if (device is None or torch.device(device).type != "cuda" or kw
                or not dt.is_floating_point):
            return real_empty(*size, dtype=dtype, device=device, **kw)
        return margined(shape, dt, device)

    def empty_like(t, **kw):
        if kw or not t.is_cuda or not t.dtype.is_floating_point:
            return real_empty_like(t, **kw)
        return margined(tuple(t.shape), t.dtype, t.device)

    def check_margins(name):
        torch.cuda.synchronize()
        keep = []
        for ref, numel in live:
            t = ref()
            if t is None:
                continue
            keep.append((ref, numel))
            for part in (t._base[:MARGIN], t._base[MARGIN + numel:]):
                if not torch.isnan(part).all():
                    margin_writes.append((name, tuple(t.shape)))
        live[:] = keep

    def checked(mod, name):
        fn = getattr(mod, name)

        def run(*a, **k):
            y = fn(*a, **k)
            check_margins(name)
            return y
        # the wrapper counts its launches through its module's name
        run.launches = fn.launches
        return fn, run

    def poison():
        torch.cuda.empty_cache()
        hold = []
        for _ in range(10):
            try:
                hold.append(torch.full((1 << 29,), float("nan"),
                                       device="cuda"))
            except torch.OutOfMemoryError:
                break
        hold += [torch.full((s,), float("nan"), device="cuda")
                 for s in (1 << 20, 1 << 16) for _ in range(64)]
        torch.cuda.synchronize()

    def busy():
        with torch.cuda.stream(side):
            for _ in range(20):
                big @ big
        return model(x)

    def poisoned():
        poison()
        return model(x)

    def with_margins():
        wrapped = [(mod, name, *checked(mod, name)) for mod, name in (
            (k1, "conv3x3_f32"), (k1, "conv3x3_head_f32"),
            (k1, "conv2x2_s2d_f32"), (kr, "conv3x3_rdb_f32"))]
        torch.empty, torch.empty_like = empty, empty_like
        for mod, name, _, run in wrapped:
            setattr(mod, name, run)
        try:
            return model(x)
        finally:
            torch.empty, torch.empty_like = real_empty, real_empty_like
            for mod, name, fn, run in wrapped:
                fn.launches = run.launches
                setattr(mod, name, fn)

    held_off: list = []
    fwd = FusedRDB.forward

    def held():
        def one(self, t, plain=False, skip=None):
            y = fwd(self, t, plain, skip)
            c = self._composition(t)
            c = c if skip is None else skip + 0.2 * c
            if not torch.equal(y, c):
                held_off.append(int((y != c).sum()))
            return y
        FusedRDB.forward = one
        try:
            return model(x)
        finally:
            FusedRDB.forward = fwd

    conditions = {"plain": lambda: model(x), "busy": busy,
                  "poisoned": poisoned, "margined": with_margins,
                  "held": held}
    failed = False
    for seed in range(args.seeds):
        x = torch.rand((n, h, w, 12), generator=torch.Generator()
                       .manual_seed(seed)).to("cuda")
        ref = model(x, plain=True)
        first = model(x)
        worst, unequal, runs = cs.rel_err(first, ref)[1], 0, 1
        held_off.clear()
        margin_writes.clear()
        for name, fn in conditions.items():
            for _ in range(1 if name == "held" else args.reps):
                out = fn()
                torch.cuda.synchronize()
                runs += 1
                worst = max(worst, cs.rel_err(out, ref)[1])
                unequal += not (torch.equal(out, first)
                                and bool(torch.isfinite(out).all()))
                del out
        bad = (unequal or worst > cs.TOL_F32_FORWARD or held_off
               or margin_writes)
        failed |= bool(bad)
        print(f"seed {seed}: {runs} forwards ({args.reps} each plain, busy, "
              f"poisoned, margined; 1 held) on {(n, h, w, 12)}: "
              f"{unequal} not bit-equal to the first or not finite; worst "
              f"rel err vs the plain forward {worst:.3g} (bar "
              f"{cs.TOL_F32_FORWARD}); RDBs unequal to the composition "
              f"{len(held_off)} of 69; margin writes {len(margin_writes)} "
              f"{margin_writes[:4]}", flush=True)
        del ref, first
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
