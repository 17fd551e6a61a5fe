"""Shared arithmetic of the kernels' roofline shares."""

from .. import peaks


def share(rec, match, work_key):
    """100 x (least time the H100 could take for one call: the larger of
    bytes over HBM bandwidth and operations over the float32 peak) / (mean
    device time of the kernels whose name holds ``match``)."""
    us = [d for name, _, d in rec["events"]["kernels"] if match in name]
    work = rec.get(work_key)
    if not us or work is None:
        return None
    nbytes, ops = work
    least_s = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FLOAT32_FLOPS)
    mean_s = sum(us) / len(us) * 1e-6
    return 100.0 * least_s / mean_s
