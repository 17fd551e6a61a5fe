"""Device-resident MD dispatch for cl.md (dynamics='DEVICE'), port of
``autoforce_tpu/cl/device_wrap.py``.

``replicas = R`` in ARGS runs an R-walker ensemble (md/replica_md.py):
rattled, re-thermalized copies of the input structure, all learning into
one model; frames of walker 0 are written to the trajectory.
"""

from .. import units
from ..md.device_md import DeviceMD


def _run_chunked(dyn, picos, dt, write_frame, loginterval):
    steps = int(picos * 1000 / dt) if picos > 0 else int(-picos)
    done = 0
    while done < steps:
        n = min(max(loginterval, 25), steps - done)
        dyn.run(n)
        write_frame()
        done += n


def run_device_md(atoms, calc, dt, temperature_K, friction, picos,
                  write_frame, loginterval, thermostat="auto", tdamp=None,
                  replicas=1):
    kw = dict(temperature_K=temperature_K, friction=friction / units.fs,
              chunk=max(loginterval, 25), thermostat=thermostat,
              tdamp=tdamp * units.fs if tdamp else None)
    if replicas and int(replicas) > 1:
        from ..md.replica_md import ReplicaMD
        from ..system import maxwell_boltzmann_velocities

        systems = [atoms]
        for r in range(1, int(replicas)):
            s = atoms.copy()
            s.rattle(0.02, seed=r)
            maxwell_boltzmann_velocities(s, temperature_K or 300, seed=r)
            s.calc = calc
            systems.append(s)
        dyn = ReplicaMD(systems, calc, dt * units.fs, **kw)
    else:
        dyn = DeviceMD(atoms, calc, dt * units.fs, **kw)
    _run_chunked(dyn, picos, dt, write_frame, loginterval)


def run_device_npt(atoms, calc, dt, temperature_K, stress_GPa, picos,
                   write_frame, loginterval, tdamp=25, pdamp=100,
                   bulk_modulus=None, mask=None, iso=False):
    """cl.md dynamics='DEVICE' with bulk_modulus: on-card MTK NPT
    (md/device_npt.py) — flexible-cell by default with the reference's
    mask semantics, isotropic with ``iso`` (cl/md.py host-path args)."""
    from ..md.device_npt import DeviceNPT

    dyn = DeviceNPT(
        atoms, calc, dt * units.fs, temperature_K=temperature_K,
        pressure_GPa=stress_GPa, tdamp=tdamp * units.fs,
        pdamp=pdamp * units.fs, bulk_modulus_GPa=bulk_modulus,
        chunk=max(loginterval, 25), isotropic=bool(iso), mask=mask,
    )
    _run_chunked(dyn, picos, dt, write_frame, loginterval)
