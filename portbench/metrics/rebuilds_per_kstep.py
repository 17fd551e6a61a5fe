"""In-loop neighbor-table rebuilds (the port's ``af.rebuild`` spans: one
at each chunk start and one per served skin breach) per 1,000 committed
MD steps of the slice."""

from ._spans import count

UNIT = "rebuilds/kstep"


def read(rec):
    steps = rec.get("slice_steps") or 0
    events = rec["events"]
    n = count(events, "af.rebuild")
    if not steps or not events["kernels"] or not n:
        return None
    return 1000.0 * n / steps
