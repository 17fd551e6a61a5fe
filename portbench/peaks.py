"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the card's full 700 W): the denominators of every roofline and mfu
share the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
# 67 TFLOP/s is both the float64 tensor-core rate (the Gram's DGEMMs) and
# the float32 rate outside the tensor cores (the SOAP kernels)
FLOAT64_TENSOR_FLOPS = 67e12
FLOAT32_FLOPS = 67e12
