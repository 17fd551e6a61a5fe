"""Device kernels in the slice per MD step."""

UNIT = "launches/step"


def read(rec):
    steps = rec.get("slice_steps") or 0
    kernels = rec["events"]["kernels"]
    if not steps or not kernels:
        return None
    return len(kernels) / steps
