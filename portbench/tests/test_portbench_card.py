"""On the card: each cell's control, the reference in the program's place
one precision below the configuration's (networks' operands in float8,
NL-means in bfloat16), has to come out not correct at the cell's own size.
Skips without a GPU."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("esrgan-photos", 4),
                                          ("sdx4-web448", 11)])
def test_control_is_not_correct(cuda_device, cell, seconds):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds",
         str(seconds), "--trace", "0", "--control", "lower"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
