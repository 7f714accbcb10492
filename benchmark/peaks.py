"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity), at its full power limit of 700 W. Roofline shares and ``mfu``
metrics are stated against these, with the card's power limit printed
beside them (``run.py`` prints ``nvidia-smi``'s reading)."""

HBM_BYTES_PER_S = 3.35e12     # HBM3
BF16_FLOPS = 989e12           # bf16 / fp16 tensor cores
INT8_OPS = 1979e12            # int8 tensor cores
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
TF32_FLOPS = 495e12


def roofline_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time of a piece of work: the larger of its operations over
    the compute peak and its bytes over the HBM peak."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
