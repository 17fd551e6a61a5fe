"""Molecular dynamics drivers: host integrators and the device-resident
chunk loop."""

from .langevin import Langevin
from .verlet import VelocityVerlet

__all__ = ["VelocityVerlet", "Langevin", "DeviceMD"]


def __getattr__(name):
    # lazy: the device driver imports the engine stack
    if name == "DeviceMD":
        from .device_md import DeviceMD

        return DeviceMD
    raise AttributeError(name)
