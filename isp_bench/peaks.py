"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit)."""

HBM_BYTES_S = 3.35e12   # HBM3
F32_FLOPS = 67e12       # float32 outside the tensor cores
