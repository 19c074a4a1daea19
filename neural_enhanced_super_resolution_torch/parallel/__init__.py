"""Parallelism layer: the tiling engine (one GPU)."""

from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, extract_tiles, pad_to_grid, process_tiled,
    process_tiled_to_host, stitch_tiles)

__all__ = ["TilingCancelled", "extract_tiles", "pad_to_grid",
           "process_tiled", "process_tiled_to_host", "stitch_tiles"]
