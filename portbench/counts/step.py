"""FLOPs of one MD step of the port, counted from shapes.

The float64 Gram of the N atoms' descriptors (N, D) against the m
inducing descriptors (m, D) is one (N, D) x (D, m) product forward and one
(N, m) x (m, D) product in the backward: 4 N m D.  The SOAP kernels add
the operations of :func:`.soap.soap_work`.  The power spectrum, the
kernel's power and the integrator, O(N (S nf)^2 L + N m) each, are left
out: at the configurations' widths they are a few percent of the counted
work at most, and leaving them out can only lower the share.
"""


def gram_flops(natoms, m, D):
    return 4.0 * natoms * m * D


def step_flops(natoms, m, D, fwd_ops, bwd_ops):
    return gram_flops(natoms, m, D) + float(fwd_ops) + float(bwd_ops)
