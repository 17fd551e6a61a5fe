"""Device time per MD step (ms) of the in-loop neighbor rebuild: the
operations launched inside the port's ``af.rebuild`` spans
(``neighbors_device.device_neighbor_table``, the species gather,
``reverse_slots``, the ``ok`` reductions), the chunk-start and the breach
rebuilds together, over the slice's committed steps."""

from ._spans import ms_per_step

UNIT = "ms/step"


def read(rec):
    return ms_per_step(rec, "af.rebuild")
