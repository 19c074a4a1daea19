"""Model layer: RRDBNet and its checkpoints, SegFormer, SwinIR."""

from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    RRDBNet, RRDBNetConfig, fuse_rdb, pixel_unshuffle)
from neural_enhanced_super_resolution_torch.models.swinir import (
    SwinIRConfig, SwinIRModel, init_swinir, load_swinir)
from neural_enhanced_super_resolution_torch.models.weights import (
    init_rrdbnet, load_state_dict, params_from_jax, save_state_dict,
    segformer_params_from_jax, swinir_params_from_jax)

__all__ = ["RRDBNet", "RRDBNetConfig", "fuse_rdb", "pixel_unshuffle",
           "SwinIRConfig", "SwinIRModel", "init_swinir", "load_swinir",
           "init_rrdbnet", "load_state_dict", "params_from_jax",
           "save_state_dict", "segformer_params_from_jax",
           "swinir_params_from_jax"]
