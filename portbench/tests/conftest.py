"""The benchmark's own tests: CPU tests of the harness at tiny sizes, and
card tests (marker ``cuda``) that skip without a GPU, decided inside a
fixture."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips without one")


@pytest.fixture()
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a card test")
    return "cuda"


def tiny_cell(which: str) -> dict:
    """A cell at test size, in the shape ``harness.load_cell`` returns."""
    with open(os.path.join(HERE, "data", "tiny_cells.json")) as f:
        spec = json.load(f)[which]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = {"esrgan": "esrgan-photos", "sdx4": "sdx4-web448"}[which]
    # the real cell's limits: the faults must fail what the cell holds
    conf = next(c for c in bench["configs"] if c["name"] == next(
        w["config"] for w in bench["workloads"] if w["name"] == name))
    with open(os.path.join(ROOT, conf["file"])) as f:
        spec["config"]["limits"] = json.load(f)["limits"]
    return {"name": name, "chips": 1, "config": spec["config"],
            "config_name": f"tiny-{which}", "mix": spec["mix"],
            "end_to_end": [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]}
