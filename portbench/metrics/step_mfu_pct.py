"""The MD step's counted FLOPs over (wall time per step x 67 TFLOP/s),
the wall time taken in the traced run's window outside the slice (%)."""

from .. import peaks

UNIT = "%"


def read(rec):
    flops = rec.get("flops_per_step")
    wall = rec.get("step_wall_s")
    if not flops or not wall or not rec["events"]["kernels"]:
        return None
    return 100.0 * flops / (wall * peaks.FLOAT64_TENSOR_FLOPS)
