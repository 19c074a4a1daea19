"""The port's repo-root entry points: ``main_torch.py`` (the counterpart of
``main.py``) and the ``nesr_torch`` alias package (of ``nesr``), on the
CPU.

Each subprocess blocks ``jax``, the JAX package and its ``nesr`` alias in
``sys.modules``, so that an import of any of them fails the run; the
request through ``main_torch.py`` runs with no GPU visible
(``CUDA_VISIBLE_DEVICES`` empty) and the CLI's default ``--device auto``,
and must fail with the pipeline's error rather than run on the CPU, as
``tests/test_torch_pipeline.py::test_cuda_request_without_gpu_raises``
holds for the pipeline, on the same tiny checkpoint.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

import neural_enhanced_super_resolution_torch as port
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)
BLOCKED = ("jax", "neural_enhanced_super_resolution_tpu", "nesr")


def _without_jax(code: str, *args: str, env=None):
    """Runs ``code`` in a fresh interpreter at the repo root with jax, the
    JAX package and ``nesr`` blocked; returns the finished process."""
    prelude = ("import sys\n"
               f"for _m in {BLOCKED!r}:\n"
               "    sys.modules[_m] = None\n")
    return subprocess.run([sys.executable, "-c", prelude + code, *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, **(env or {})))


def _run_main(*args: str, env=None):
    return _without_jax("import runpy\n"
                        "sys.argv = ['main_torch.py', *sys.argv[1:]]\n"
                        "runpy.run_path('main_torch.py', "
                        "run_name='__main__')\n", *args, env=env)


def test_main_torch_help_exits_0():
    proc = _run_main("--help")
    assert proc.returncode == 0, proc.stderr
    assert "--cli" in proc.stdout and "--device" in proc.stdout


@pytest.mark.parametrize("mod", [
    "nesr_torch", "nesr_torch.utils", "nesr_torch.utils.image_utils",
    "nesr_torch.utils.downloader", "nesr_torch.utils.metrics",
    "nesr_torch.gui", "nesr_torch.nesr",
])
def test_alias_module_paths_are_the_ports(mod):
    """Each of the reference's module paths under ``nesr_torch`` is the
    port's module (``nesr_torch`` itself re-exports the port's pipeline)."""
    got = importlib.import_module(mod)
    want = {"nesr_torch": port,
            "nesr_torch.nesr": "neural_enhanced_super_resolution_torch."
                               "pipeline"}.get(
        mod, mod.replace("nesr_torch", "neural_enhanced_super_resolution_"
                                       "torch"))
    want = importlib.import_module(want) if isinstance(want, str) else want
    if mod == "nesr_torch":
        assert got.SuperResolutionPipeline is want.SuperResolutionPipeline
        assert got.__version__ == want.__version__
    else:
        assert got is want


def test_alias_symbols_without_jax():
    """The reference's imports resolve to the port's objects in a process
    where jax and the JAX package cannot be imported."""
    proc = _without_jax(
        "import nesr_torch.nesr\n"
        "from nesr_torch.utils.downloader import download_models\n"
        "from nesr_torch.gui import NESRApplication\n"
        "from nesr_torch import SuperResolutionPipeline\n"
        "import neural_enhanced_super_resolution_torch as p\n"
        "from neural_enhanced_super_resolution_torch.utils import "
        "downloader\n"
        "from neural_enhanced_super_resolution_torch import gui\n"
        "assert nesr_torch.nesr.SuperResolutionPipeline is "
        "p.SuperResolutionPipeline is SuperResolutionPipeline\n"
        "assert download_models is downloader.download_models\n"
        "assert NESRApplication is gui.NESRApplication\n"
        "print('resolved')\n")
    assert proc.returncode == 0, proc.stderr
    assert "resolved" in proc.stdout


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny checkpoint of tests/test_torch_pipeline.py (same widths,
    same seed)."""
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(0))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("ckpt")
                                   / "tiny_x4.pth"))


def test_main_torch_request_without_gpu_fails(tmp_path, ckpt, test_image):
    """A one-image CLI request through main_torch.py at the default
    ``--device auto`` with no GPU: exit 1 with the pipeline's "no CUDA
    GPU" error, no output written, no JAX imported."""
    src = str(tmp_path / "in.png")
    imwrite_rgb(src, test_image[:16, :16])
    cfg = {"iterations": 1, "use_diffusion": False,
           "segment_enhancement": False, "denoise_level": 0,
           "data_parallel": "off", "esrgan_model_path": ckpt,
           "esrgan_arch": dict(TINY), "output_dir": str(tmp_path / "cli")}
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = str(tmp_path / "res" / "final.png")
    proc = _run_main("--cli", "-i", src, "-c", cfg_path, "-n", "1", "-o",
                     out, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no CUDA GPU" in proc.stdout + proc.stderr
    assert "Traceback" not in proc.stderr
    assert not os.path.exists(out)
