"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

# TF32 tensor cores: the highest rate any product of float32 inputs reaches
# on the card, so a share of it cannot pass 100 % whatever the float32
# implementation (SIMT float32 is 67e12, 3xTF32 a third of this).
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
