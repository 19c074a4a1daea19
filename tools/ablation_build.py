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


def apply_edits(name: str, texts: dict, edits) -> dict:
    """``texts`` (file name -> text) with each edit (old, new) applied to
    every file: a string replaced wherever it appears, or a compiled
    pattern substituted; one that matches nothing in any file fails
    loudly."""
    texts = dict(texts)
    for old, new in edits:
        n = 0
        for key, text in texts.items():
            if isinstance(old, re.Pattern):
                texts[key], k = old.subn(new, text)
            else:
                k = text.count(old)
                texts[key] = text.replace(old, new)
            n += k
        if n == 0:
            raise SystemExit(f"{name}: edit no longer matches: {old!r}")
    return texts


def prepare(out: str, name: str, source: str, edits=(), *, csrc: str = CSRC,
            finish=None, ptxas: bool = False, headers=()):
    """Copy ``csrc`` to ``out/name``, apply ``edits`` to its ``source``
    and to those of the ``headers`` it holds (apply_edits), and start nvcc
    on that source alone; returns (library path, edited text of the source, the
    nvcc process, its output piped). ``finish`` (text -> text) runs on the
    source after the edits. ``ptxas`` adds the ptxas report (registers,
    spills) to nvcc's output."""
    src_dir = os.path.join(out, name)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc, src_dir)
    texts = {}
    for key in (source, *headers):
        if key == source or os.path.exists(os.path.join(src_dir, key)):
            with open(os.path.join(src_dir, key)) as f:
                texts[key] = f.read()
    texts = apply_edits(name, texts, edits)
    if finish is not None:
        texts[source] = finish(texts[source])
    for key, text in texts.items():
        with open(os.path.join(src_dir, key), "w") as f:
            f.write(text)
    text = texts[source]
    path = os.path.join(src_dir, source)
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
