"""The one traffic generator: a mix file of parameters -> the requests.

A mix (``portbench/traffic/<cell>.json``) states image sizes (each ``[w,
h]``, in equal shares), how many distinct images of each size set-up
makes (``pool_per_size``), the scene (``content``), and how many of the
window's requests the correctness check compares (``check``). The order
of sizes is seeded and made in blocks: each block holds every size once,
in an order drawn from the seed, so every window holds the stated shares
to within one request and every seed the same work in another order.

Images are smooth seeded scenes with photo-like Gaussian noise
(``scene``): a base colour, octaves of random grids interpolated
bilinearly (each ``[cell, std]``: grid points ``cell`` px apart, std in
levels; a luminance grid shared by the channels plus a ``chroma`` share of
a grid per channel), then noise of std ``noise_std``, clipped to uint8.
Halving the std with the cell gives the falling spectrum of natural
images, and the interpolation leaves no hard edges.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["Mix", "scene", "load_mix"]


def load_mix(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _lerp(n: int, cell: int) -> np.ndarray:
    """(n, n // cell + 2) weights of bilinear interpolation from grid
    points ``cell`` px apart."""
    pos = np.arange(n, dtype=np.float32) / cell
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    a = np.zeros((n, n // cell + 2), np.float32)
    a[np.arange(n), i0] = 1.0 - frac
    a[np.arange(n), i0 + 1] = frac
    return a


def scene(rng: np.random.Generator, h: int, w: int,
          content: dict) -> np.ndarray:
    """(h, w, 3) uint8: a smooth seeded scene plus Gaussian noise."""
    lo, hi = content.get("mean", (64.0, 192.0))
    img = np.empty((h, w, 3), np.float32)
    img[:] = rng.uniform(lo, hi, 3).astype(np.float32)
    chroma = float(content.get("chroma", 0.35))
    for cell, std in content["octaves"]:
        cell = int(cell)
        gh, gw = h // cell + 2, w // cell + 2
        grid = (rng.standard_normal((gh, gw, 1), np.float32)
                + chroma * rng.standard_normal((gh, gw, 3), np.float32))
        grid *= float(std) / np.sqrt(1.0 + chroma ** 2)
        rows = (_lerp(h, cell) @ grid.reshape(gh, gw * 3)).reshape(
            h, gw, 3).transpose(0, 2, 1).reshape(h * 3, gw)
        img += (rows @ _lerp(w, cell).T).reshape(h, 3, w).transpose(0, 2, 1)
    img += float(content.get("noise_std", 12.0)) * rng.standard_normal(
        img.shape, np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


class Mix:
    """The requests of one run: pools of images and a seeded order."""

    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = int(seed)
        self.sizes = [tuple(int(v) for v in s) for s in spec["sizes"]]
        content = spec["content"]
        rng = np.random.default_rng([self.seed, 1])
        self.pools = {
            s: [scene(rng, s[1], s[0], content)
                for _ in range(int(spec.get("pool_per_size", 1)))]
            for s in self.sizes}
        self._order_rng = np.random.default_rng([self.seed, 2])
        self._order: list[int] = []
        self.prompt = spec.get("prompt")

    def size_of(self, i: int) -> tuple[int, int]:
        """(w, h) of request ``i``: block i // n, a permutation per block."""
        n = len(self.sizes)
        while len(self._order) <= i:
            self._order.extend(int(k) for k in self._order_rng.permutation(n))
        return self.sizes[self._order[i]]

    def image(self, i: int) -> np.ndarray:
        """The image of request ``i``: its size's pool, in turn."""
        s = self.size_of(i)
        seen = sum(1 for j in range(i) if self.size_of(j) == s)
        pool = self.pools[s]
        return pool[seen % len(pool)]

    def check_indices(self) -> list[int]:
        """The requests whose answers the check compares, drawn from the
        seed among the first ``check.within``: with ``one_per_size`` one
        of each size (the longest among them), else ``check.requests``."""
        chk = self.spec["check"]
        within = int(chk["within"])
        rng = np.random.default_rng([self.seed, 3])
        if chk.get("one_per_size"):
            picks = []
            for s in self.sizes:
                cands = [i for i in range(within) if self.size_of(i) == s]
                picks.append(int(rng.choice(cands)))
            return sorted(picks)
        return sorted(int(i) for i in rng.choice(
            within, int(chk["requests"]), replace=False))
