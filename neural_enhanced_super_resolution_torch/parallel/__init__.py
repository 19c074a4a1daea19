"""Parallelism layer: the tiling engine and parity tiler, device meshes,
tile-batch and strip sharding, the member-parallel ensemble."""

from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, extract_tiles, pad_to_grid, process_tiled,
    process_tiled_to_host, process_with_tiling_parity, stitch_tiles)
from neural_enhanced_super_resolution_torch.parallel.mesh import (
    make_mesh, replicate, shard_tiles)
from neural_enhanced_super_resolution_torch.parallel.sharded import (
    halo_exchange_strips, process_strips_sharded, process_tiled_sharded)
from neural_enhanced_super_resolution_torch.parallel.ensemble import (
    ensemble_members_sharded)

__all__ = ["TilingCancelled", "extract_tiles", "pad_to_grid",
           "process_tiled", "process_tiled_to_host",
           "process_with_tiling_parity", "stitch_tiles",
           "make_mesh", "shard_tiles", "replicate",
           "process_tiled_sharded", "halo_exchange_strips",
           "process_strips_sharded", "ensemble_members_sharded"]
