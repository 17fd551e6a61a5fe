"""Share of the slice's wall time in which no operation runs on the
device, from the union of the device intervals (%)."""

from ..trace import busy_us

UNIT = "%"


def read(rec):
    wall = rec.get("slice_wall_s") or 0.0
    if not wall or not rec["events"]["kernels"]:
        return None
    return 100.0 * (1.0 - busy_us(rec["events"]) * 1e-6 / wall)
