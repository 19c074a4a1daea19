"""Checks every hand-written kernel of the port for the faults the CUDA
toolkit's compute-sanitizer looks for, on one CUDA GPU.

    python3 tools/torch_sanitize.py [--family NAME ...] [--csrc DIR]

Each kernel family (FAMILIES, float32 first) runs its cases, small shapes
at full width, in child processes of this script:

1. Under compute-sanitizer (beside nvcc), once for each of ``--tool
   racecheck`` (shared-memory hazards), ``synccheck`` (barrier misuse),
   ``initcheck`` (reads of device memory nothing wrote) and ``memcheck``
   (out-of-bounds and misaligned accesses, ``--leak-check no``). The first
   run is a probe: where the sanitizer cannot run the program (it answers
   "Device not supported" on a machine whose NVIDIA driver does not let
   it attach), every sanitizer line says so and names the reason.
2. Checks of the same faults that need no sanitizer, each in a child of
   its own, every output held bit for bit against a plain child's
   (normal allocator, the kernels as built):
   guard   every tensor its own cudaMalloc between 64 KiB guards
           (tools/guard_alloc.cu through PyTorch's pluggable allocator):
           a write outside a tensor shows in its guards (memcheck's job);
   poison  the same, every new tensor filled with NaN (0xFF bytes) in one
           child and with 0x7F bytes in another: a read of memory nothing
           wrote changes the output (initcheck's job);
   shift   every tensor 4 bytes off its alignment, so the kernels' 16-byte
           paths give way to their scalar forms (the float32 families; the
           bf16 wrappers refuse such tensors, and the line says so);
   jitter  the kernels rebuilt with a per-warp pause of 0-2 us after every
           block barrier, named barrier, cluster barrier and mbarrier wait
           (a quarter of them), each case run three times: an order the
           code does not enforce shows as a changed output (racecheck's
           and synccheck's job; a barrier a warp misses shows as a hang,
           which the child's time limit, CHILD_TIMEOUT, reports).

``--csrc`` checks another ``csrc`` directory's kernels (e.g. a ``git
archive`` of an earlier commit under ``outputs/``), built under
``build/sanitize/``, with this script's cases: to show a fault that a
repair removed. Prints one line a family and check: the count of errors
and the first report. Exits 1 on any error (a sanitizer that could not
run is none: its lines say so), 3 without a GPU. About three minutes on
an H100, two kernel builds included (the plain one, the jittered copy
under ``build/sanitize/``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "sanitize")
CSRC = os.path.join(ROOT, "neural_enhanced_super_resolution_torch", "csrc")
SANITIZER_TOOLS = ("racecheck", "synccheck", "initcheck", "memcheck")
JITTER_REPS = 3
POISONS = {"nan": 0xFF, "big": 0x7F}
SHIFT = 4   # bytes: every pointer 4-byte aligned and no more
CHILD_TIMEOUT = 600   # seconds a child may take
DEVICE = "cuda"   # where the cases run (the CPU only to rehearse them)

# What the jittered copy adds to csrc/common.cuh (inside namespace nesr):
# a pause of 0 or up to ~2 us, a quarter of the time, from the clock, the
# block and the warp.
JITTER = """
__device__ __forceinline__ void jitter() {
  const unsigned long long t = clock64();
  unsigned h = (unsigned)t * 2654435761u ^ blockIdx.x * 0x9E3779B9u ^
               blockIdx.y * 0xC2B2AE35u ^ (threadIdx.x >> 5) * 0x85EBCA6Bu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  __nanosleep((h & 3) ? 0u : (h >> 21));
}
"""
# (pattern, replacement, files): the pauses; each must match somewhere.
JITTER_EDITS = [
    (re.escape("namespace nesr {\n"), "namespace nesr {\n" + JITTER,
     ("common.cuh",)),
    (re.escape("  } while (!done);\n}"), "  } while (!done);\n  jitter();\n}",
     ("common.cuh",)),
    (re.escape("__syncthreads();"), "__syncthreads(); nesr::jitter();", None),
    (r'(?s)(asm volatile\("bar\.sync.*?"memory"\);)',
     r"\1 nesr::jitter();", None),
    (re.escape("cluster.sync();"), "cluster.sync(); nesr::jitter();", None),
]


def _rng(torch, seed: int):
    return torch.Generator().manual_seed(seed)


def _randn(torch, gen, *shape, scale=1.0, dtype=None):
    t = torch.randn(*shape, generator=gen) * scale
    return t.to(DEVICE, dtype or torch.float32).contiguous()


def _rdb_weights(torch, gen, nf: int, g: int):
    shapes = [(nf, 4 * g + nf), (g, 3 * g + nf), (g, 2 * g + nf),
              (g, g + nf), (g, nf)]
    fw = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in shapes]
    return fw, torch.randn((4 * g + nf,), generator=gen) * 0.1


def _rrdb(torch, rdbs, x):
    """One RRDB on the RDB step: three RDBs, the third folding the
    residual (15 launches)."""
    return rdbs[2](rdbs[1](rdbs[0](x)), skip=x)


def case_rdb_f32(torch):
    """The float32 RDB step's three forms: one RRDB at nf 64 / g 32 on 1 x
    40 x 40 with the skip; one RDB at nf 18 / g 6 (scalar epilogue, K1f's
    4-byte staging) with and without it."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    gen = _rng(torch, 1)
    rdbs = [FusedRDB(*_rdb_weights(torch, gen, 64, 32), torch.float32,
                     DEVICE, kernel=False) for _ in range(3)]
    x = _randn(torch, gen, 1, 40, 40, 64, scale=0.5)
    odd = FusedRDB(*_rdb_weights(torch, gen, 18, 6), torch.float32, DEVICE,
                   kernel=False)
    xo = _randn(torch, gen, 1, 24, 20, 18, scale=0.5)
    so = _randn(torch, gen, 1, 24, 20, 18, scale=0.5)
    return [_rrdb(torch, rdbs, x), odd(xo), odd(xo, skip=so)]


def case_k1f(torch):
    """K1f's SAME conv at conv_first (12 -> 64) and conv_body (64 -> 64)
    on 1 x 40 x 40, with the bias."""
    from neural_enhanced_super_resolution_torch.kernels import conv3x3_f32
    gen = _rng(torch, 2)
    x = _randn(torch, gen, 1, 40, 40, 12)
    f = _randn(torch, gen, 1, 40, 40, 64)
    return [conv3x3_f32(x, _randn(torch, gen, 3, 3, 12, 64, scale=0.1),
                        _randn(torch, gen, 64, scale=0.1)),
            conv3x3_f32(f, _randn(torch, gen, 3, 3, 64, 64, scale=0.05),
                        _randn(torch, gen, 64, scale=0.1))]


def case_head_f32(torch):
    """conv3x3_head_f32 at up1 (64 -> 256, LeakyReLU, depth-to-space) on
    1 x 40 x 40 and up2 (64 -> 256, LeakyReLU) on 1 x 80 x 80."""
    from neural_enhanced_super_resolution_torch.kernels import (
        conv3x3_head_f32)
    gen = _rng(torch, 3)
    return [conv3x3_head_f32(_randn(torch, gen, 1, 40, 40, 64),
                             _randn(torch, gen, 3, 3, 64, 256, scale=0.05),
                             _randn(torch, gen, 256, scale=0.1), True, True),
            conv3x3_head_f32(_randn(torch, gen, 1, 80, 80, 64),
                             _randn(torch, gen, 3, 3, 64, 256, scale=0.05),
                             _randn(torch, gen, 256, scale=0.1), True)]


def case_conv2x2_f32(torch):
    """conv2x2_s2d_f32 at hr (256 -> 256, padding 1, LeakyReLU, the frame
    mask) on 1 x 40 x 40 and last (256 -> 12, VALID, depth-to-space) on
    1 x 41 x 41."""
    from neural_enhanced_super_resolution_torch.kernels import (
        conv2x2_s2d_f32)
    gen = _rng(torch, 4)
    return [conv2x2_s2d_f32(_randn(torch, gen, 1, 40, 40, 256),
                            _randn(torch, gen, 2, 2, 256, 256, scale=0.03),
                            _randn(torch, gen, 256, scale=0.1), True, 1,
                            True, False),
            conv2x2_s2d_f32(_randn(torch, gen, 1, 41, 41, 256),
                            _randn(torch, gen, 2, 2, 256, 12, scale=0.03),
                            _randn(torch, gen, 12, scale=0.1), False, 0,
                            False, True)]


def case_rdb_bf16(torch):
    """The K1 step: one RRDB at nf 64 / g 32 on 1 x 40 x 40 in bf16, with
    the skip."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        FusedRDB)
    gen = _rng(torch, 5)
    rdbs = [FusedRDB(*_rdb_weights(torch, gen, 64, 32), torch.bfloat16,
                     DEVICE, kernel=False) for _ in range(3)]
    return [_rrdb(torch, rdbs, _randn(torch, gen, 1, 40, 40, 64, scale=0.5,
                                      dtype=torch.bfloat16))]


def case_k1(torch):
    """K1's SAME conv in bf16 at conv_first and conv_body on 1 x 40 x
    40."""
    from neural_enhanced_super_resolution_torch.kernels import conv3x3
    gen = _rng(torch, 6)
    bf = torch.bfloat16
    return [conv3x3(_randn(torch, gen, 1, 40, 40, 12, dtype=bf),
                    _randn(torch, gen, 3, 3, 12, 64, scale=0.1, dtype=bf),
                    _randn(torch, gen, 64, scale=0.1)),
            conv3x3(_randn(torch, gen, 1, 40, 40, 64, dtype=bf),
                    _randn(torch, gen, 3, 3, 64, 64, scale=0.05, dtype=bf),
                    _randn(torch, gen, 64, scale=0.1), True)]


def case_head(torch):
    """K1's head 3x3 form (conv3x3_head) at up1 and up2 in bf16, with the
    JAX rounding (round_first)."""
    from neural_enhanced_super_resolution_torch.kernels import conv3x3_head
    gen = _rng(torch, 7)
    bf = torch.bfloat16
    return [conv3x3_head(_randn(torch, gen, 1, 40, 40, 64, dtype=bf),
                         _randn(torch, gen, 3, 3, 64, 256, scale=0.05,
                                dtype=bf),
                         _randn(torch, gen, 256, scale=0.1), True, d2s=True,
                         round_first=True),
            conv3x3_head(_randn(torch, gen, 1, 80, 80, 64, dtype=bf),
                         _randn(torch, gen, 3, 3, 64, 256, scale=0.05,
                                dtype=bf),
                         _randn(torch, gen, 256, scale=0.1), True,
                         round_first=True)]


def case_conv2x2(torch):
    """K1's 2x2 form (conv2x2_s2d) at hr and last in bf16."""
    from neural_enhanced_super_resolution_torch.kernels import conv2x2_s2d
    gen = _rng(torch, 8)
    bf = torch.bfloat16
    return [conv2x2_s2d(_randn(torch, gen, 1, 40, 40, 256, dtype=bf),
                        _randn(torch, gen, 2, 2, 256, 256, scale=0.03,
                               dtype=bf),
                        _randn(torch, gen, 256, scale=0.1), True, 1, True,
                        False),
            conv2x2_s2d(_randn(torch, gen, 1, 41, 41, 256, dtype=bf),
                        _randn(torch, gen, 2, 2, 256, 12, scale=0.03,
                               dtype=bf),
                        _randn(torch, gen, 12, scale=0.1), False, 0, False,
                        True)]


def case_k2(torch):
    """K2 (rdb_fused): one RDB at nf 64 / g 32 on 1 x 40 x 40."""
    from neural_enhanced_super_resolution_torch.kernels import rdb_fused
    gen = _rng(torch, 9)
    fw, b = _rdb_weights(torch, gen, 64, 32)
    return [rdb_fused(_randn(torch, gen, 1, 40, 40, 64, scale=0.5,
                             dtype=torch.bfloat16),
                      [w.to(DEVICE, torch.bfloat16) for w in fw],
                      b.to(DEVICE))]


def case_k4(torch):
    """The K4 step with int8_amax: one int8 RDB (one int8_amax, five
    steps) at nf 64 / g 32 on 1 x 40 x 40 with the skip."""
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        Int8RDB, quantize_rdb)
    gen = _rng(torch, 10)
    fw, b = _rdb_weights(torch, gen, 64, 32)
    rdb = Int8RDB(*quantize_rdb(fw), b, DEVICE)
    x = _randn(torch, gen, 1, 40, 40, 64, scale=0.5, dtype=torch.bfloat16)
    return [rdb(x, skip=x)]


# (B, H, Sq, Skv, d): the UNet's 32^2 self-attention and the VAE
# mid-block of a 48x40 request (one head, d 512; K3f splits its keys).
FLASH_CASES = [(1, 8, 1024, 1024, 64), (1, 1, 1920, 1920, 512)]


def _flash(torch, fn, dtype, seed):
    gen = _rng(torch, seed)
    return [fn(*(_randn(torch, gen, b, h, s, d, dtype=dtype)
                 for s in (sq, skv, skv)))
            for b, h, sq, skv, d in FLASH_CASES]


def case_k3(torch):
    """K3 (flash_attention, bf16) at a UNet-sized and a VAE-sized call."""
    from neural_enhanced_super_resolution_torch.kernels import (
        flash_attention)
    return _flash(torch, flash_attention, torch.bfloat16, 11)


def case_k3f(torch):
    """K3f (flash_attention_f32) at the same calls."""
    from neural_enhanced_super_resolution_torch.kernels import (
        flash_attention_f32)
    return _flash(torch, flash_attention_f32, torch.float32, 12)


def case_nlmeans(torch):
    """NL-means (nl_means_fields): one field over three channels (sigma 6)
    on 1 x 40 x 56, and the Lab joint pass on 2 x 37 x 23; both grids
    under one wave, so both launch as split clusters."""
    from neural_enhanced_super_resolution_torch.kernels import (
        nl_means_fields)
    gen = _rng(torch, 13)
    one = (torch.rand((1, 40, 56, 3), generator=gen) * 255).to(DEVICE)
    lab = torch.rand((2, 37, 23, 3), generator=gen) * 60
    lab[..., 0] += 20
    return [nl_means_fields(one, [((0, 1, 2), 10.0)], 6.0),
            nl_means_fields(lab.to(DEVICE), [((0,), 3.0), ((1, 2), 5.0)])]


FAMILIES = {
    "rdb_f32": (case_rdb_f32, "csrc/rdb_f32.cu"),
    "k1f": (case_k1f, "csrc/conv3x3_f32.cu"),
    "head_f32": (case_head_f32, "csrc/conv3x3_head_f32.cu"),
    "conv2x2_f32": (case_conv2x2_f32, "csrc/conv2x2_f32.cu"),
    "rdb_bf16": (case_rdb_bf16, "csrc/rdb_bf16.cu"),
    "k1": (case_k1, "csrc/conv3x3.cu"),
    "head": (case_head, "csrc/conv3x3_head.cu"),
    "conv2x2": (case_conv2x2, "csrc/conv2x2.cu"),
    "k2": (case_k2, "csrc/rdb_fused.cu"),
    "k4": (case_k4, "csrc/rdb_int8.cu"),
    "k3": (case_k3, "csrc/flash_attn.cu"),
    "k3f": (case_k3f, "csrc/flash_attn_f32.cu"),
    "nlmeans": (case_nlmeans, "csrc/nlmeans.cu"),
}


# ---- the child: one configuration, every family asked for ---------------

def _use_guard_allocator(torch, so: str):
    alloc = torch.cuda.memory.CUDAPluggableAllocator(so, "guard_malloc",
                                                     "guard_free")
    torch.cuda.memory.change_current_allocator(alloc)
    lib = ctypes.CDLL(so)
    lib.guard_check_all.argtypes = [ctypes.c_char_p]
    lib.guard_check_all.restype = ctypes.c_longlong
    return lib


def child(args) -> int:
    if args.csrc:
        # another csrc (the jittered copy, or --csrc's), built apart from
        # the package's own library
        os.environ["NESR_TORCH_BUILD_DIR"] = args.build
    import torch
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels import (
        KernelInputError, _build)
    guard = _use_guard_allocator(torch, args.guard) if args.guard else None
    if args.csrc:
        _build._CSRC = args.csrc
    _build.load_library()
    results, seen = {}, 0
    msg = ctypes.create_string_buffer(256)
    for fam in args.family:
        fn = FAMILIES[fam][0]
        runs = []
        try:
            for _ in range(args.reps):
                runs.append([t.detach().cpu() for t in fn(torch)])
                torch.cuda.synchronize()
        except KernelInputError as exc:
            if not args.refusal_ok:
                raise
            results[fam] = {"refused": str(exc)}
            continue
        entry = {"runs": runs}
        if guard is not None:
            count = guard.guard_check_all(msg)
            entry["guard"] = (count - seen, msg.value.decode())
            seen = count
        results[fam] = entry
    torch.save(results, args.out)
    print("torch_sanitize child ok", flush=True)
    return 0


# ---- the parent -----------------------------------------------------------

def _bits(torch, t):
    """t's values as integers of its width, so that equality is bit for
    bit (NaN payloads and signed zeros included)."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(width[t.element_size()])


def _unequal(torch, runs, ref) -> int:
    n = 0
    for outs in runs:
        for a, b in zip(outs, ref):
            n += (a.numel() if a.shape != b.shape
                  else int((_bits(torch, a) != _bits(torch, b)).sum()))
    return n


def _child_cmd(out: str, families, extra=()) -> list[str]:
    return [sys.executable, os.path.abspath(__file__), "--child", "--out",
            out, "--family", *families, *extra]


def _run(cmd, env, timeout) -> tuple[int, str]:
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        text = exc.stdout or ""
        text = text if isinstance(text, str) else text.decode()
        return 124, text + f"\ntimed out after {timeout} s"
    return proc.returncode, proc.stdout + proc.stderr


def _sanitizer_lines(families, own) -> tuple[list[str], int]:
    """compute-sanitizer's four tools over each family: (lines, errors)."""
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels import _build
    try:
        cs = _build.cuda_tool("compute-sanitizer")
    except _build.KernelError as exc:
        return [f"torch_sanitize compute-sanitizer: not run ({exc})"], 0
    out = os.path.join(OUT, "sanitizer.pt")
    lines, errors = [], 0
    for i, fam in enumerate(families):
        for tool in SANITIZER_TOOLS:
            cmd = [cs, "--tool", tool, "--print-limit", "10"]
            if tool == "memcheck":
                cmd += ["--leak-check", "no"]
            rc, text = _run(cmd + _child_cmd(out, [fam], own),
                            dict(os.environ), CHILD_TIMEOUT)
            if i == 0 and tool == SANITIZER_TOOLS[0] and (
                    "torch_sanitize child ok" not in text):
                why = next((ln.strip("= ").strip() for ln in text.splitlines()
                            if "Error:" in ln), f"exit {rc}")
                lines.append(f"torch_sanitize compute-sanitizer: cannot run "
                             f"the program on this machine ({why}); every "
                             "(family, tool) below: not run")
                lines += [f"torch_sanitize {f} {t}: not run"
                          for f in families for t in SANITIZER_TOOLS]
                return lines, 0
            m = re.search(r"(ERROR SUMMARY|RACECHECK SUMMARY): (\d+)", text)
            n = int(m.group(2)) if m else 1
            if "torch_sanitize child ok" not in text:
                n = max(n, 1)
            first = next((ln.strip("= ").strip() for ln in text.splitlines()
                          if ln.startswith("========= ") and "SUMMARY" not in
                          ln and "COMPUTE-SANITIZER" not in ln
                          and ln.strip("= ")), "")
            errors += n
            lines.append(f"torch_sanitize {fam} {tool}: {n} errors"
                         + (f" (first: {first})" if n else ""))
    return lines, errors


def _jitter_copy(csrc: str) -> str:
    """csrc copied under build/sanitize/csrc_jitter with the pauses."""
    dst = os.path.join(OUT, "csrc_jitter")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    texts = {}
    for name in sorted(os.listdir(dst)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(dst, name)) as f:
                texts[name] = f.read()
    for pattern, new, files in JITTER_EDITS:
        hits = 0
        for name in (files or texts):
            texts[name], k = re.subn(pattern, new, texts[name])
            hits += k
        if not hits:
            raise SystemExit(f"torch_sanitize: jitter edit matches nothing: "
                             f"{pattern!r}")
    for name, text in texts.items():
        if name.endswith(".cu") and "nesr::jitter" in text:
            text = '#include "common.cuh"\n' + text   # where it is not yet
        with open(os.path.join(dst, name), "w") as f:
            f.write(text)
    return dst


def _build_guard() -> str:
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels import _build
    so = os.path.join(OUT, "libguard_alloc.so")
    cmd = [_build._nvcc(), "-std=c++17", "-O2", "-Xcompiler", "-fPIC",
           "-shared", os.path.join(ROOT, "tools", "guard_alloc.cu"), "-o", so]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"torch_sanitize: guard allocator build failed\n"
                         f"{proc.stdout}{proc.stderr}")
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", nargs="+", choices=list(FAMILIES),
                    default=list(FAMILIES))
    ap.add_argument("--csrc", help="another csrc directory to check")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--guard", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--refusal-ok", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)
    import torch
    if not torch.cuda.is_available():
        print("torch_sanitize: needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels import _build
    t0 = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"torch_sanitize on {card} (nvidia-smi name, power.limit); "
          f"families {args.family}; kernels of "
          f"{os.path.abspath(args.csrc) if args.csrc else CSRC}", flush=True)
    csrc = os.path.abspath(args.csrc) if args.csrc else CSRC
    # the build, before any child needs it (another csrc: by the first
    # child, into a directory of its own)
    own = [] if csrc == CSRC else ["--csrc", csrc, "--build",
                                   os.path.join(OUT, "lib_csrc")]
    if not own:
        _build.load_library()
    guard = _build_guard()
    fams = args.family
    f32 = [f for f in fams if f in ("rdb_f32", "k1f", "head_f32",
                                    "conv2x2_f32", "k3f", "nlmeans")]
    jitter_build = os.path.join(OUT, "jitter_lib")
    configs = {
        "plain": (fams, {}, own),
        "nan": (fams, {"NESR_GUARD_POISON": str(POISONS["nan"])},
                ["--guard", guard, *own]),
        "big": (fams, {"NESR_GUARD_POISON": str(POISONS["big"])},
                ["--guard", guard, *own]),
        "shift": (f32, {"NESR_GUARD_SHIFT": str(SHIFT)},
                  ["--guard", guard, "--refusal-ok", *own]),
        "jitter": (fams, {}, ["--csrc", _jitter_copy(csrc), "--build",
                              jitter_build, "--reps", str(JITTER_REPS)]),
    }
    got, errors = {}, 0
    for name, (which, env, extra) in configs.items():
        if not which:
            continue
        # every family in one child; where it fails, each family alone,
        # so that the failure is the family's
        got[name] = {}
        for group in ([which], [[f] for f in which]):
            for fs in group:
                out = os.path.join(OUT, f"{name}.pt")
                rc, text = _run(_child_cmd(out, fs, extra),
                                dict(os.environ, **env), CHILD_TIMEOUT)
                if rc == 0 and "torch_sanitize child ok" in text:
                    got[name].update(torch.load(out))
                elif len(fs) == 1:
                    why = [ln for ln in text.strip().splitlines()
                           if "Error:" in ln] or [text.strip()[-300:]]
                    got[name][fs[0]] = {"failed": f"exit {rc}: {why[0]}"}
            if set(got[name]) == set(which):
                break
    plain = got.get("plain", {})
    for fam in fams:
        ref = plain.get(fam, {}).get("runs", [None])[0]
        lines = []
        if ref is None:
            print(f"torch_sanitize {fam}: no plain run to compare with "
                  f"({plain.get(fam, {}).get('failed')})", flush=True)
            errors += 1
            continue
        failed = {name: got[name][fam]["failed"] for name in got
                  if "failed" in got[name].get(fam, {})}
        finite = sum(int((~torch.isfinite(t.float())).sum()) for t in ref)
        bad = [f"{finite} values not finite in the plain run"] if finite \
            else []
        for name, why in failed.items():
            lines.append((name, 1, f"the child failed: {why}"))
        guard_n, guard_first = 0, ""
        for name in ("nan", "big", "shift"):
            g = got.get(name, {}).get(fam, {}).get("guard")
            if g and g[0]:
                guard_n += g[0]
                guard_first = guard_first or f"{name}: {g[1]}"
        lines.append(("guard", guard_n, guard_first))
        pois = {name: _unequal(torch, got[name][fam]["runs"], ref)
                for name in ("nan", "big")
                if "runs" in got.get(name, {}).get(fam, {})}
        lines.append(("poison", sum(pois.values()) + finite,
                      "; ".join(bad + [f"{n} values unequal to the plain run "
                                       f"with poison {k}"
                                       for k, n in pois.items() if n])))
        if fam in f32:
            s = got.get("shift", {}).get(fam, {})
            if "refused" in s:
                lines.append(("shift", 0, "n/a, the wrapper refuses "
                              f"unaligned tensors: {s['refused']}"))
            elif "runs" in s:
                n = _unequal(torch, s["runs"], ref)
                lines.append(("shift", n, f"{n} values unequal to the "
                                          "aligned run" if n else ""))
        else:
            lines.append(("shift", 0, "n/a: the bf16 wrappers take 16-byte "
                                      "aligned tensors only"))
        j = got.get("jitter", {}).get(fam, {})
        if "runs" in j:
            n = _unequal(torch, j["runs"], ref)
            lines.append(("jitter", n, f"{n} values unequal to the plain run "
                                       f"over {len(j['runs'])} runs"
                          if n else f"{len(j['runs'])} runs"))
        for check, n, note in lines:
            errors += n
            print(f"torch_sanitize {fam} {check}: {n} errors"
                  + (f" ({note})" if note else ""), flush=True)
    lines, n = _sanitizer_lines(fams, own)
    for line in lines:
        print(line, flush=True)
    errors += n
    print(f"torch_sanitize: {errors} errors in all, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
