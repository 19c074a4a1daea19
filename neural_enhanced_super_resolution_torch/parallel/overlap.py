"""Stage-level overlap: the ESRGAN and diffusion branches on disjoint slots.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/overlap.py``.
The two branches are data-independent (both read the segmented image; their
outputs meet only at the ensemble), so on a multi-device mesh ESRGAN's tile
batch runs data-parallel over one set of slots while the diffusion loop
owns the rest. One thread enqueues both before either result is read; on
one device the two dispatches serialise on its stream.
"""

from __future__ import annotations

from typing import Callable, Sequence

__all__ = ["split_mesh", "overlap_branches"]


def split_mesh(devices: Sequence, diffusion_share: float = 0.25
               ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split a device list into (ESRGAN slots, diffusion slots), as slot
    indices into ``devices``.

    The diffusion branch is one loop with no tile batch to shard, so it
    takes the last ``max(1, int(n * diffusion_share))`` slots; with one
    device both branches share slot 0."""
    n = len(devices)
    if n == 1:
        return (0,), (0,)
    k = max(1, int(n * diffusion_share))
    esr = tuple(range(n - k)) or (0,)
    return esr, tuple(range(n - k, n))


def overlap_branches(esrgan_branch: Callable, diffusion_branch: Callable
                     | None):
    """Call both branches back to back and return both results.

    Each callable must enqueue its device work and return device tensors
    without waiting for them, so the second branch is in flight before
    anyone waits on the first; the caller synchronises afterwards."""
    esrgan_out = esrgan_branch()
    diffusion_out = (diffusion_branch() if diffusion_branch is not None
                     else None)
    return esrgan_out, diffusion_out
