"""The SOAP backward kernel's share of its H100 roofline (%)."""

from ._roofline import share

UNIT = "%"


def read(rec):
    return share(rec, "soap_bwd_kernel", "soap_bwd_work")
