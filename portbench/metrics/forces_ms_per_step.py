"""Device time per MD step (ms) of the force evaluations: the operations
launched inside the port's ``af.forces`` spans (descriptors, the SOAP
kernels, the Gram and the backward), those of issued steps and of the
evaluations after each rebuild, over the slice's committed steps."""

from ._spans import ms_per_step

UNIT = "ms/step"


def read(rec):
    return ms_per_step(rec, "af.forces")
