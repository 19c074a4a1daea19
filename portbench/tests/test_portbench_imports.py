"""The no-JAX rule: top-level module names compared whole."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
import run  # noqa: E402


def test_forbidden_names_are_compared_whole(monkeypatch):
    base = set(run.forbidden_modules())
    for name in ("nesr_torch", "nesr_torch.nesr",
                 "neural_enhanced_super_resolution_torch.kernels",
                 "nesrx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(run.forbidden_modules()) == base
    for name in ("nesr.cli", "jax.numpy", "jaxlib", "flax.linen",
                 "neural_enhanced_super_resolution_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(run.forbidden_modules()) - base == {
        "nesr", "jax", "jaxlib", "flax", "neural_enhanced_super_resolution_tpu"}


def test_harness_and_program_load_no_jax():
    """Everything a run imports, in a fresh process: the harness, the
    configuration kind with the port's modules it builds, the reference,
    the counts and the metric readers."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "sys.path.insert(0, sys.argv[1] + '/portbench');"
        "import run; from portbench import harness;"
        "import neural_enhanced_super_resolution_torch as p;"
        "from neural_enhanced_super_resolution_torch.runtime import executor;"
        "from neural_enhanced_super_resolution_torch.models import rrdbnet, segformer;"
        "from neural_enhanced_super_resolution_torch.models.diffusion import pipeline, unet, vae, clip_text;"
        "from portbench.reference import nets, ops, request;"
        "from portbench.counts import model_flops, rrdbnet as r, attention;"
        "import json; b = json.load(open(sys.argv[1] + '/BENCHMARK.json'));"
        "[harness.load_part('metrics', m['name']) for m in b['per_layer']];"
        "[harness.load_part('e2e', m['name']) for m in b['end_to_end']];"
        "harness.load_part('models', 'nesr_pipeline');"
        "print(run.forbidden_modules())")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
