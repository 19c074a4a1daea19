"""``tools/torch_sanitize.py`` on the CPU: what it can show without a card.

Every kernel source of the port but the standalone K4 (on no path) has a
family of cases; each family's cases run on the CPU (the plain versions)
to finite outputs, the same twice; the jittered copy's edits all match
the sources and put a pause after every barrier; the bit-for-bit count
sees a one-bit difference and a NaN payload. The checks themselves need a
GPU (``python3 tools/torch_sanitize.py`` on a machine with the card).
"""

import importlib.util
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "neural_enhanced_super_resolution_torch", "csrc")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_sanitize", os.path.join(ROOT, "tools", "torch_sanitize.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ts = _tool()


def test_families_cover_every_kernel_source():
    sources = {f"csrc/{f}" for f in os.listdir(CSRC) if f.endswith(".cu")}
    covered = {src for _, src in ts.FAMILIES.values()}
    assert covered == sources - {"csrc/conv3x3_int8.cu"}
    assert list(ts.FAMILIES)[:4] == ["rdb_f32", "k1f", "head_f32",
                                     "conv2x2_f32"]


@pytest.mark.parametrize("family", list(ts.FAMILIES))
def test_family_cases_run_on_the_cpu(family, monkeypatch):
    monkeypatch.setattr(ts, "DEVICE", "cpu")
    case = ts.FAMILIES[family][0]
    first, second = case(torch), case(torch)
    assert first and all(torch.isfinite(t.float()).all() for t in first)
    assert ts._unequal(torch, [second], first) == 0


def test_jitter_copy_pauses_after_every_barrier(tmp_path, monkeypatch):
    monkeypatch.setattr(ts, "OUT", str(tmp_path))
    dst = ts._jitter_copy(CSRC)
    for name in os.listdir(dst):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(dst, name)) as f:
            text = f.read()
        assert text.count("__syncthreads();") == text.count(
            "__syncthreads(); nesr::jitter();"), name
        assert len(re.findall(r'"bar\.sync', text)) == len(re.findall(
            r'(?s)"bar\.sync.*?"memory"\); nesr::jitter\(\);', text)), name
        if "nesr::jitter" in text and name.endswith(".cu"):
            assert '#include "common.cuh"' in text, name
    with open(os.path.join(dst, "common.cuh")) as f:
        common = f.read()
    assert "void jitter()" in common and "  jitter();\n}" in common


def test_unequal_counts_bits():
    a = torch.tensor([1.0, float("nan"), -0.0])
    assert ts._unequal(torch, [[a.clone()]], [a]) == 0
    b = a.clone()
    b[2] = 0.0
    assert ts._unequal(torch, [[b]], [a]) == 1
    c = a.clone()
    c[0] = torch.nextafter(c[0], torch.tensor(2.0))
    assert ts._unequal(torch, [[c], [a]], [a]) == 1
