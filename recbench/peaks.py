"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  The port keeps TF32 off
(``core/device.py`` ``full_float32_matmul``), so its products run at the
float32 rate outside the tensor cores."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
