"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates, boost clock 1.98 GHz, at its 700 W limit; a card set lower
runs slower, so every result line carries the card's name and the runs
record its power limit beside the shares)."""

SMS = 132
CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12  # the highest f64 rate (DMMA)
FP32_FLOPS = 67e12
# the integer / logic pipe: 16 lanes a sub-partition, 64 an SM a clock
ALU_OPS_PER_S = SMS * 64 * CLOCK_HZ  # 1.6727e13
