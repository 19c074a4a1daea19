"""Stage timing.

Counterpart of ``neural_enhanced_super_resolution_tpu/runtime/profiler.py``.
Each stage is a ``torch.profiler.record_function`` range (visible in a
``torch.profiler`` trace) and accumulates host wall clock. CUDA work is
asynchronous, so by default the clock is read only after the GPU has been
synchronised, at both ends of the stage: the current GPU, or each CUDA
device of ``devices`` (the devices a multi-device layout uses, and no
other: a synchronize on a GPU the process does not use would create a CUDA
context there). A stage that raises is recorded all the same. A stage
opened with ``sync_start`` or ``sync_end`` false leaves that end
unsynchronised (under stage overlap the ESRGAN branch's stage times its
dispatch only, and its work is waited for later).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import torch

logger = logging.getLogger("nesr.profiler")

__all__ = ["StageTimer"]


def _sync(devices) -> None:
    """Wait for the CUDA devices among ``devices``, or for the current GPU
    when ``devices`` is None."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    if devices is None:
        torch.cuda.synchronize()
        return
    for device in dict.fromkeys(torch.device(d) for d in devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates per-stage wall clock, synchronising the GPU first."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_start: bool = True,
              sync_end: bool = True, devices=None):
        if sync_start:
            _sync(devices)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"nesr/{name}"):
                yield
        finally:
            # Record even when the stage raises: a failing stage must show
            # up in the table, not vanish.
            try:
                if sync_end:
                    _sync(devices)
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1
                logger.debug("stage %s: %.3fs", name, dt)

    def summary_lines(self, megapixels_out: float | None = None) -> list[str]:
        total = sum(self.totals.values())
        lines = [f"  {name:<22s} {t:8.3f}s ({self.counts[name]} calls)"
                 for name, t in sorted(self.totals.items(),
                                       key=lambda kv: -kv[1])]
        if megapixels_out and total > 0:
            lines.append(f"  throughput: {megapixels_out / total:.3f} "
                         "MP_out/s")
        return lines

    def log_summary(self, megapixels_out: float | None = None):
        for line in self.summary_lines(megapixels_out):
            logger.info(line)
