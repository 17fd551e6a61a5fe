"""Molecular dynamics drivers: host integrators and the device-resident
chunk loops."""

from .langevin import Langevin
from .nose_hoover import MTKNPT, NoseHooverNVT
from .npt import BerendsenNPT, BerendsenNVT
from .verlet import VelocityVerlet

__all__ = ["VelocityVerlet", "Langevin", "BerendsenNPT", "BerendsenNVT",
           "MTKNPT", "NoseHooverNVT", "DeviceMD", "DeviceNPT"]


def __getattr__(name):
    # lazy: the device drivers import the engine stack
    if name == "DeviceMD":
        from .device_md import DeviceMD

        return DeviceMD
    if name == "DeviceNPT":
        from .device_npt import DeviceNPT

        return DeviceNPT
    raise AttributeError(name)
