"""What the kernel ablation tools share: a copy of the port's ``csrc/``
with one source edited, built alone by nvcc for sm_90a, and a launch
timed with CUDA events.

    from ablation_build import prepare, timed   # from a script in tools/
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "neural_enhanced_super_resolution_torch")
CSRC = os.path.join(PKG, "csrc")


def nvcc() -> str:
    sys.path.insert(0, ROOT)
    from neural_enhanced_super_resolution_torch.kernels import _build
    return _build._nvcc()


def prepare(out: str, name: str, source: str, edits=(), *, csrc: str = CSRC,
            finish=None, ptxas: bool = False):
    """Copy ``csrc`` to ``out/name``, apply ``edits`` to its ``source`` and
    start nvcc on that file alone; returns (library path, edited text,
    the nvcc process, its output piped).

    Each edit is (old, new): a string replaced wherever it appears, or a
    compiled pattern substituted; one that matches nothing fails loudly.
    ``finish`` (text -> text) runs after the edits. ``ptxas`` adds the
    ptxas report (registers, spills) to nvcc's output."""
    src_dir = os.path.join(out, name)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc, src_dir)
    path = os.path.join(src_dir, source)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if isinstance(old, re.Pattern):
            text, n = old.subn(new, text)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n == 0:
            raise SystemExit(f"{name}: edit no longer matches: {old!r}")
    if finish is not None:
        text = finish(text)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(src_dir, f"lib_{name}.so")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", *(["-Xptxas", "-v"] if ptxas else []),
           "-shared", path, "-o", so]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, text, proc


def timed(torch, fn, reps: int) -> float:
    """ms a call of ``fn`` by CUDA events over ``reps`` calls after one
    warm-up."""
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
