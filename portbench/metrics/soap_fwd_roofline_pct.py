"""The SOAP forward kernel's share of its H100 roofline (%)."""

from ._roofline import share

UNIT = "%"


def read(rec):
    return share(rec, "soap_fwd_kernel", "soap_fwd_work")
