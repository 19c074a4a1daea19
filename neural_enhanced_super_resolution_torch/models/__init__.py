"""Model layer: RRDBNet and its checkpoints, SegFormer, SwinIR."""

from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    Int8RDB, RRDBNet, RRDBNetConfig, TrainableRRDBNet, fuse_rdb,
    pixel_unshuffle, quantize_rdb)
from neural_enhanced_super_resolution_torch.models.swinir import (
    SwinIRConfig, SwinIRModel, init_swinir, load_swinir)
from neural_enhanced_super_resolution_torch.models.weights import (
    init_rrdbnet, int8_rrdbnet_params_from_jax, load_state_dict,
    members_from_jax, params_from_jax, save_state_dict,
    segformer_params_from_jax, swinir_params_from_jax)

__all__ = ["Int8RDB", "RRDBNet", "RRDBNetConfig", "TrainableRRDBNet",
           "fuse_rdb",
           "int8_rrdbnet_params_from_jax", "pixel_unshuffle", "quantize_rdb",
           "SwinIRConfig", "SwinIRModel", "init_swinir", "load_swinir",
           "init_rrdbnet", "load_state_dict", "members_from_jax",
           "params_from_jax", "save_state_dict", "segformer_params_from_jax",
           "swinir_params_from_jax"]
