"""CUDA runtime calls that wait for the card (stream, event or device
synchronize; blocking copies), per 1,000 MD steps of the slice."""

UNIT = "syncs/kstep"


def read(rec):
    steps = rec.get("slice_steps") or 0
    runtime = rec["events"]["runtime"]
    if not steps or not runtime:
        return None
    n = sum(1 for name, _, _ in runtime
            if "Synchronize" in name or name == "cudaMemcpy")
    return 1000.0 * n / steps
