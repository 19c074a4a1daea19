"""Parallelism layer: the tiling engine (one GPU) and the parity tiler."""

from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, extract_tiles, pad_to_grid, process_tiled,
    process_tiled_to_host, process_with_tiling_parity, stitch_tiles)

__all__ = ["TilingCancelled", "extract_tiles", "pad_to_grid",
           "process_tiled", "process_tiled_to_host",
           "process_with_tiling_parity", "stitch_tiles"]
