"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every roofline share and of ``mfu``."""

BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
