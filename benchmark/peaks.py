"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

FP32_FLOPS = 67e12        # FP32 outside the tensor cores
BF16_FLOPS = 989e12       # bf16 tensor cores
HBM_BYTES_S = 3.35e12     # HBM3
