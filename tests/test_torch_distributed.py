"""The port's multi-host runtime (``runtime/distributed.py``), on the CPU.

The counterparts of tests/test_distributed.py: init is a no-op without a
coordinator, the hybrid mesh is (processes, *inner axes), a bad inner
product raises, the balanced tile split, and two real processes joined by
``torch.distributed`` over gloo that stage a global tile batch from
``local_tile_slice``, compute, all-gather and compare (the port's modules
only, no JAX in the workers).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from neural_enhanced_super_resolution_torch.runtime import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
       "NESR_COORDINATOR_ADDRESS", "NESR_NUM_PROCESSES", "NESR_PROCESS_ID")


def test_init_is_noop_without_coordinator(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_multihost() is False
    assert distributed.is_initialized() is False


def test_failed_init_stays_on_one_host(monkeypatch, caplog):
    """As the JAX package: a bad coordinator is logged, not raised."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NESR_COORDINATOR_ADDRESS", "127.0.0.1:notaport")
    assert distributed.init_multihost(backend="gloo") is False
    assert distributed.is_initialized() is False
    assert any("continuing on one host" in r.getMessage()
               for r in caplog.records)


def test_hybrid_mesh_axes_single_host():
    mesh = distributed.make_hybrid_mesh({"dp": 4, "tp": 2},
                                        devices=[CPU] * 8)
    assert mesh.axis_names == ("dcn", "dp", "tp")
    assert mesh.devices.shape == (1, 4, 2)
    assert mesh.local() == (CPU,) * 8
    assert distributed.make_hybrid_mesh(devices=[CPU] * 3).devices.shape == \
        (1, 3)


def test_hybrid_mesh_rejects_bad_ici_product():
    with pytest.raises(ValueError):
        distributed.make_hybrid_mesh({"dp": 3}, devices=[CPU] * 8)


def test_local_tile_slice_single_process():
    s = distributed.local_tile_slice(10)
    assert (s.start, s.stop) == (0, 10)


def test_local_tile_slice_arithmetic(monkeypatch):
    """4 processes: every tile owned once, in order, 3/3/2/2."""
    owned, sizes = [], []
    for pid in range(4):
        monkeypatch.setattr(distributed, "_world", lambda p=pid: (4, p))
        s = distributed.local_tile_slice(10)
        owned.extend(range(s.start, s.stop))
        sizes.append(s.stop - s.start)
    assert owned == list(range(10))
    assert sizes == [3, 3, 2, 2]


_WORKER = r'''
import os, sys
pid, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.modules["jax"] = None           # the port's modules only
sys.path.insert(0, root)
os.environ["NESR_COORDINATOR_ADDRESS"] = "127.0.0.1:" + port
os.environ["NESR_NUM_PROCESSES"] = "2"
os.environ["NESR_PROCESS_ID"] = str(pid)
import torch
import torch.distributed as dist
from neural_enhanced_super_resolution_torch.runtime import distributed

assert distributed.init_multihost(backend="gloo") is True
assert distributed.is_initialized() and dist.get_world_size() == 2
mesh = distributed.make_hybrid_mesh(devices=[torch.device("cpu")] * 2)
assert mesh.devices.shape == (2, 2), mesh.devices.shape

# The global tile batch, staged by its owner only (local_tile_slice).
n = 8
full = torch.arange(n * 4 * 4 * 3, dtype=torch.float32).reshape(n, 4, 4, 3)
sl = distributed.local_tile_slice(n)
assert sl == (slice(0, 4) if pid == 0 else slice(4, 8)), sl
local = full[sl] * 2.0 + 1.0
total = full[sl].sum()
dist.all_reduce(total)
assert total.item() == full.sum().item(), total
parts = [torch.empty_like(local) for _ in range(2)]
dist.all_gather(parts, local)
assert torch.equal(torch.cat(parts), full * 2.0 + 1.0)
dist.destroy_process_group()
print("WORKER_OK", pid, flush=True)
'''


def test_two_process_gloo_end_to_end(tmp_path):
    """Two processes join over gloo, stage a global tile batch from their
    local slices, compute, all-reduce, all-gather and compare."""
    worker = tmp_path / "gloo_worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    procs = [subprocess.Popen(
                 [sys.executable, str(worker), str(pid), port, ROOT],
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                 env=env)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        assert f"WORKER_OK {pid}" in out
