"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), copied from ``chip_smoke.py:429-441``.
A run prints the card's name and power limit beside them."""

PEAK_FP32_FLOPS = 67e12  # CUDA cores
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES_S = 3.35e12  # HBM3
# 132 SMs x 128 FP32 lanes x 2 flops an FMA set the clock; the MUFU unit
# (ex2, lg2, rcp) returns 16 results a clock an SM
SMS = 132
SM_CLOCK_HZ = PEAK_FP32_FLOPS / (2 * SMS * 128)
MUFU_S = SMS * 16 * SM_CLOCK_HZ
