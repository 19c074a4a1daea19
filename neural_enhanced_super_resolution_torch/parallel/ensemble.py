"""Member-parallel ensemble: one member a slot, the weighted sum on slot 0.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/ensemble.py``
(which stacks the members' params on a leading axis sharded over the mesh
and adds the weighted outputs with one ``psum``). Here the members are a
list, one a slot; every member reads the same replicated image, and the
weighted outputs are added on the home slot in member order.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch import nn

from neural_enhanced_super_resolution_torch.parallel.mesh import (
    module_on, replicate, sum_on)

__all__ = ["ensemble_members_sharded"]


def _place(member: Any, device: torch.device) -> Any:
    if isinstance(member, nn.Module):
        return module_on(member, device)
    return {k: v.to(device, non_blocking=True) for k, v in member.items()}


def ensemble_members_sharded(model_fn: Callable, members: Sequence,
                             image: torch.Tensor,
                             mesh: Sequence[torch.device],
                             weights: Sequence[float] | None = None
                             ) -> torch.Tensor:
    """Run member i on slot i and return the weighted sum of the outputs.

    model_fn: (member, (H, W, C) image on the member's device) ->
    (H', W', C'). members: one ``nn.Module`` or state dict a slot (moved to
    the slot's device when elsewhere). weights: one a member (default
    uniform). Returns the float32 (H', W', C') sum on slot 0's device."""
    mesh = tuple(mesh)
    n = len(mesh)
    if len(members) != n:
        raise ValueError(f"{len(members)} members for {n} slots")
    if weights is None:
        weights = [1.0 / n] * n
    w = torch.as_tensor(weights, dtype=torch.float32)
    images = replicate(image, mesh)
    outs = [model_fn(_place(m, dev), img).float() * float(w[i])
            for i, (m, dev, img) in enumerate(zip(members, mesh, images))]
    return sum_on(outs, mesh[0])
