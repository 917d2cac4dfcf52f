"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).

Every share of a peak in this benchmark is taken against the tensor
cores' dense bf16 rate, whatever the compute dtype: the port's float32
kernels already run their products on those tensor cores (W1 as three
exact bf16 parts), so the 67 TFLOP/s float32 rate would bound nothing
they do, and with 989 no correct implementation can read above 100%.
"""

PEAK_OPS_PER_S = 989e12   # dense bf16 tensor-core rate
BYTES_PER_S = 3.35e12     # HBM3 bandwidth
