#!/usr/bin/env python3
"""Where the streamed final's copies go, on the GPU machine.

    python3 tools/torch_stream_profile.py [--height 1200] [--width 1600]

Times, at the shapes of one streamed-final request (an H x W uint8 image
in 256-px tiles with 6-px halos, 16 tiles a chunk, x4 output), the pieces
of ``parallel/tiling.process_tiled_to_host`` beside the compute they
overlap: the tiling on the card, a chunk's cores to pinned memory, the
landing of a chunk in the host canvas, and a chunk's cores to pageable
memory (what the blocking form, ``.cpu()`` a chunk, pays). Host clock
around each piece, ended by a synchronize, five runs after a warm-up.
Prints the card's name and power limit beside the numbers; exits 2
without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--width", type=int, default=1600)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_stream_profile: no CUDA GPU", file=sys.stderr)
        return 2
    from neural_enhanced_super_resolution_torch.parallel import tiling

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    tile, halo, batch, scale = 256, 6, 16, 4
    h, w = args.height, args.width
    ny, nx = -(-h // tile), -(-w // tile)
    to = tile * scale
    img = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    x = torch.as_tensor(img, device="cuda")
    cores_dev = torch.empty((batch, to, to, 3), dtype=torch.uint8,
                            device="cuda")
    cores_pin = torch.empty(cores_dev.shape, dtype=torch.uint8,
                            pin_memory=True)
    canvas = np.empty((ny * to, nx * to, 3), np.uint8)

    def land():
        for j in range(batch):
            iy, ix = divmod(j, nx)
            canvas[iy * to:(iy + 1) * to, ix * to:(ix + 1) * to] = \
                cores_pin[j].numpy()

    mb = cores_dev.numel() / 1e6
    pieces = [
        (f"card tiling ({ny * nx} tiles, _tile_grid)",
         lambda: tiling._tile_grid(x, tile, halo)),
        (f"a chunk's cores to pinned memory ({mb:.1f} MB)",
         lambda: cores_pin.copy_(cores_dev, non_blocking=True)),
        (f"land a chunk in the canvas ({batch} cores, host memcpy)", land),
        (f"a chunk's cores to pageable memory ({mb:.1f} MB, .cpu())",
         lambda: cores_dev.cpu()),
    ]
    print(f"streamed-final pieces for {w}x{h} ({ny * nx} tiles, "
          f"{-(-ny * nx // batch)} chunks) on {card}", flush=True)
    for label, fn in pieces:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"  {label}: " + ", ".join(f"{t:.3f}" for t in times) + " ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
