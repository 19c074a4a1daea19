"""Device meshes for one process that drives every device of its host.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/mesh.py``.
A mesh is an ordered tuple of ``torch.device``; a *slot* is an index into
it. A device may repeat (a one-card rehearsal of a four-card layout lists
the card four times): the slots stay distinct while the devices do not, so
layouts are tracked by slot and copies are made once per distinct device.

One thread dispatches each slot's work onto its device's current stream;
nothing waits on the host between slots. A shard or halo moves with
``Tensor.to(device, non_blocking=True)``: a peer copy between cards, no
copy at all on one card.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn

__all__ = ["make_mesh", "shard_tiles", "replicate", "sum_on",
           "module_device", "module_on"]


def make_mesh(n_devices: int | None = None,
              devices: Sequence[torch.device] | None = None
              ) -> tuple[torch.device, ...]:
    """The first ``n_devices`` (default: all) of ``devices`` (default: every
    visible GPU) as a mesh."""
    if devices is None:
        from neural_enhanced_super_resolution_torch.runtime.device import (
            visible_devices)
        devices = visible_devices("cuda")
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return devs


def shard_tiles(batch: torch.Tensor, mesh: Sequence[torch.device]
                ) -> list[torch.Tensor]:
    """Split a (N, ...) batch along dim 0 into one equal shard a slot, each
    on its slot's device. N must be a multiple of the mesh size."""
    n = len(mesh)
    if batch.shape[0] % n:
        raise ValueError(f"shard_tiles: {batch.shape[0]} tiles over {n} "
                         "slots")
    per = batch.shape[0] // n
    return [batch[i * per:(i + 1) * per].to(dev, non_blocking=True)
            for i, dev in enumerate(mesh)]


def replicate(t: torch.Tensor, mesh: Sequence[torch.device]
              ) -> list[torch.Tensor]:
    """``t`` on every slot: one copy per distinct device, listed per slot
    (slots on one device share it)."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = t.to(dev, non_blocking=True)
    return [copies[dev] for dev in mesh]


def sum_on(parts: Sequence[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The slots' tensors added on ``device`` in slot order (a psum)."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device, non_blocking=True)
    return acc


def module_device(module: nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    raise ValueError("module_device: the module holds no tensor")


def module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself where it lives on ``device``, else a copy moved
    there, every parameter and buffer (K1's packed weights) included."""
    device = torch.device(device)
    if module_device(module) == device:
        return module
    return copy.deepcopy(module).to(device)
