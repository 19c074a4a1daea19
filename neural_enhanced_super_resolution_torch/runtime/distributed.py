"""Multi-host initialisation and hybrid meshes.

Counterpart of ``neural_enhanced_super_resolution_tpu/runtime/
distributed.py``. One process drives every GPU of its host (the mesh of
``parallel/mesh.py``); across hosts, ``torch.distributed`` (NCCL on the
card, gloo on the CPU) joins one process a host and carries the outer axis
of a hybrid mesh, as ``jax.distributed`` does for the JAX package.

Usage on several hosts:

    from neural_enhanced_super_resolution_torch.runtime import distributed
    distributed.init_multihost()            # no-op on one host
    mesh = distributed.make_hybrid_mesh({"dp": 4})
    # mesh.devices: (processes, 4); stage distributed.local_tile_slice(n)

Environment (torch's own names are honoured first):
  * MASTER_ADDR + MASTER_PORT / NESR_COORDINATOR_ADDRESS ("host:port") —
    process 0's address. Without one (and without a process count), init
    is a no-op.
  * WORLD_SIZE / NESR_NUM_PROCESSES, RANK / NESR_PROCESS_ID.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple

import numpy as np
import torch

logger = logging.getLogger("nesr.distributed")

__all__ = ["init_multihost", "is_initialized", "make_hybrid_mesh",
           "local_tile_slice", "HybridMesh"]

INIT_TIMEOUT_S = 300   # jax.distributed.initialize's default


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def is_initialized() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def _world() -> tuple[int, int]:
    """(process count, this process's rank); (1, 0) without init."""
    if is_initialized():
        return (torch.distributed.get_world_size(),
                torch.distributed.get_rank())
    return 1, 0


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> bool:
    """Join the process group of a multi-host run; a no-op on one host.

    Returns True when a process group was (or already is) initialised.
    Safe to call at pipeline start: without a coordinator address or a
    process count (arguments or environment) it does nothing. backend:
    None picks NCCL where a GPU is visible, else gloo. A failed init is
    logged and leaves the process on its own host (returns False)."""
    if is_initialized():
        return True
    master = _env("MASTER_ADDR")
    coord = coordinator_address or (
        f"{master}:{os.environ.get('MASTER_PORT', '29500')}" if master
        else _env("NESR_COORDINATOR_ADDRESS"))
    nproc = num_processes if num_processes is not None else _env(
        "WORLD_SIZE", "NESR_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env(
        "RANK", "NESR_PROCESS_ID")
    if coord is None and nproc is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = dict(backend=backend, init_method=f"tcp://{coord}",
                  world_size=int(nproc or 1), rank=int(pid or 0),
                  timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        torch.distributed.init_process_group(**kwargs)
    except Exception as exc:  # noqa: BLE001 — ladder: stay on one host
        # A stale WORLD_SIZE without an address, a refused connection:
        # pipeline construction must survive, on this host alone.
        logger.error("torch.distributed.init_process_group(%s) failed; "
                     "continuing on one host: %s", kwargs, exc)
        return False
    logger.info("torch.distributed initialised (%s): process %d/%d",
                backend, torch.distributed.get_rank(),
                torch.distributed.get_world_size())
    return True


class HybridMesh(NamedTuple):
    """devices: an object array (processes, *inner sizes) of
    ``torch.device``, row r holding process r's local devices (each host
    names its own GPUs alike); axis_names: ("dcn", *inner names)."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    def local(self) -> tuple[torch.device, ...]:
        """This process's devices, as a flat mesh."""
        return tuple(self.devices[_world()[1]].flat)


def make_hybrid_mesh(ici_axes: dict[str, int] | None = None,
                     dcn_axis: str = "dcn",
                     devices: list[torch.device] | None = None
                     ) -> HybridMesh:
    """A mesh whose outer axis spans the processes and whose inner axes
    split this host's devices (``devices``, default every visible GPU).

    ``ici_axes`` maps inner axis names to sizes; their product must equal
    the local device count (default: one axis "dp" over them all). The
    outer axis has the process count: 1 on one host."""
    if devices is None:
        from neural_enhanced_super_resolution_torch.runtime.device import (
            visible_devices)
        devices = visible_devices("cuda")
    n_local = len(devices)
    if ici_axes is None:
        ici_axes = {"dp": n_local}
    sizes = tuple(ici_axes.values())
    if int(np.prod(sizes)) != n_local:
        raise ValueError(
            f"ici_axes {ici_axes} product != local device count {n_local}")
    n_proc = _world()[0]
    grid = np.empty((n_proc, n_local), dtype=object)
    for r in range(n_proc):
        for i, d in enumerate(devices):
            grid[r, i] = torch.device(d)
    return HybridMesh(grid.reshape((n_proc, *sizes)),
                      (dcn_axis, *ici_axes))


def local_tile_slice(n_tiles: int) -> slice:
    """The slice of a global tile batch this process stages.

    Balanced floor/ceil split: the first ``n_tiles % n_proc`` processes
    take one tile more, so 10 tiles over 4 processes give 3/3/2/2."""
    n_proc, idx = _world()
    base, extra = divmod(n_tiles, n_proc)
    start = idx * base + min(idx, extra)
    return slice(start, start + base + (1 if idx < extra else 0))
