"""Share of the iterations the host issued (the port's ``af.step`` spans)
that committed no step (%): those queued behind a dropped ``active`` flag
before the host saw it drop.  The slice is whole chunks, so the issued
iterations and ``slice_steps`` cover the same chunks."""

from ._spans import count

UNIT = "%"


def read(rec):
    steps = rec.get("slice_steps") or 0
    events = rec["events"]
    issued = count(events, "af.step")
    if not steps or not issued or not events["kernels"]:
        return None
    return 100.0 * (issued - steps) / issued
