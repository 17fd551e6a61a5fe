"""Device time per MD step (ms) of the float64 GEMMs: the Gram's matrix
products, forward and backward (``kernels.gram`` via ``engine.rows_cov``;
the model's float64).  A kernel counts when its name holds "gemm" and a
float64 mark ("f64", "double", "dgemm" or cuBLAS/CUTLASS's "d884" /
"d16816" tensor-op tags), so the in-loop neighbor rebuild's float32
``(g + off) @ cell`` GEMM is not read as the Gram."""

UNIT = "ms/step"
FLOAT64 = ("f64", "double", "dgemm", "d884", "d16816")


def is_float64_gemm(name):
    low = name.lower()
    return "gemm" in low and any(mark in low for mark in FLOAT64)


def read(rec):
    steps = rec.get("slice_steps") or 0
    us = [d for name, _, d in rec["events"]["kernels"] if is_float64_gemm(name)]
    if not steps or not us:
        return None
    return sum(us) / steps / 1e3
