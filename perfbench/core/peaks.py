"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every
roofline and MFU share."""

HBM_BYTES_PER_S = 3.35e12          # 80 GB HBM3
FP32_FLOPS = 67e12                 # float32 outside the tensor cores
TF32_FLOPS = 495e12                # TF32 tensor cores
BF16_FLOPS = 989e12


def matmul_peak(tf32: bool) -> float:
    """The float32 matmul peak: TF32's where the card may use it."""
    return TF32_FLOPS if tf32 else FP32_FLOPS
