"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): the denominators of every roofline and
MFU share the benchmark reports."""

PEAK_BF16_FLOPS = 989e12     # FLOP/s, bf16 on the tensor cores
PEAK_FP32_FLOPS = 67e12      # FLOP/s, float32 on the CUDA cores
PEAK_HBM_BYTES = 3.35e12     # bytes/s of HBM3


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory rate, in seconds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)
