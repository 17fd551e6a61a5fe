"""Structure optimizers: host FIRE / LBFGS / UnitCellFilter / NEB and the
device-resident FIRE and NEB loops."""

from .filters import UnitCellFilter
from .fire import FIRE
from .lbfgs import LBFGS
from .neb import NEB

__all__ = ["FIRE", "LBFGS", "UnitCellFilter", "NEB", "DeviceFIRE",
           "DeviceNEB"]


def __getattr__(name):
    # lazy: the device drivers import the engine stack
    if name == "DeviceFIRE":
        from .device_fire import DeviceFIRE

        return DeviceFIRE
    if name == "DeviceNEB":
        from .device_neb import DeviceNEB

        return DeviceNEB
    raise AttributeError(name)
