"""The 95th percentile of every completed request's ``enhance_array``
wall time in the window (host clock; linear interpolation between order
statistics, numpy's default)."""

import numpy as np


def value(window):
    walls = [r["t_end"] - r["t_start"] for r in window.done]
    if not walls:
        return None
    return float(np.percentile(walls, 95))
