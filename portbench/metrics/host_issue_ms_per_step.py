"""Host time (ms) the port spends issuing one iteration of its device
loop: the mean over the ``af.step`` spans of their duration less the time
inside CUDA runtime calls within them, so the host's own issue work and
not its waits on a full launch queue."""

from ._spans import self_us

UNIT = "ms/step"


def read(rec):
    events = rec["events"]
    own = self_us(events, "af.step")
    if not own or not events["kernels"]:
        return None
    return sum(own) / len(own) / 1e3
