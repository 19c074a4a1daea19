"""Hand-written Hopper kernels of the port and their plain versions."""

from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelError, KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.attention import (
    attention_auto, flash_attention, flash_attention_f32,
    flash_attention_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3, conv3x3_f32,
    conv3x3_head, conv3x3_head_f32, conv3x3_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    conv3x3_int8, conv3x3_int8_plain, conv3x3_int8_rdb, conv3x3_int8_rdb_plain,
    int8_amax, int8_amax_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
    conv3x3_rdb, conv3x3_rdb_f32, conv3x3_rdb_plain)
from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
    rdb_fused, rdb_fused_plain)
from neural_enhanced_super_resolution_torch.kernels.nlmeans import (
    nl_means_fields, nl_means_fields_plain)

__all__ = ["KernelError", "KernelInputError", "attention_auto",
           "conv2x2_s2d", "conv2x2_s2d_f32", "conv2x2_s2d_plain", "conv3x3",
           "conv3x3_f32", "conv3x3_head", "conv3x3_head_f32", "conv3x3_int8",
           "conv3x3_int8_plain",
           "conv3x3_int8_rdb", "conv3x3_int8_rdb_plain", "int8_amax",
           "int8_amax_plain",
           "conv3x3_plain", "conv3x3_rdb", "conv3x3_rdb_f32",
           "conv3x3_rdb_plain",
           "flash_attention", "flash_attention_f32",
           "flash_attention_plain", "nl_means_fields",
           "nl_means_fields_plain", "rdb_fused", "rdb_fused_plain"]
