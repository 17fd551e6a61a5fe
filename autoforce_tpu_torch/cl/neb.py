"""ML NEB: ``python -m autoforce_tpu_torch.cl.neb -i images.extxyz``
(port of ``autoforce_tpu/cl/neb.py``, counterpart of theforce/cl/neb.py).
Reads the ARGS file of the working directory."""

from __future__ import annotations

from .. import cl as cline
from ..opt import FIRE, NEB
from ..opt.neb import interpolate_images


def neb(
    images,
    nimages=7,
    fmax=0.05,
    climb=True,
    spring=0.1,
    trajectory="neb.extxyz",
    relax_ends=True,
    device=False,
):
    """images: list of Systems (2 endpoints -> interpolated, or full band).
    ``device=True`` relaxes the whole band on the device
    (opt/device_neb.py: the moving images stacked as one configuration,
    one forward and one backward kernel launch per band evaluation)."""
    calc = cline.gen_active_calc()
    if len(images) == 2:
        if relax_ends:
            from ..opt import LBFGS

            for im in images:
                im.calc = calc
                LBFGS(im).run(fmax=fmax, steps=300)
        images = interpolate_images(images[0], images[-1], nimages)
    for im in images:
        im.calc = calc
    if device:
        from ..opt.device_neb import DeviceNEB

        band = DeviceNEB(images, calc, k=spring, climb=climb, dt=0.05,
                         maxstep=0.1)
        band.run(fmax=fmax, steps=500)
    else:
        band = NEB(images, k=spring, climb=climb)
        opt = FIRE(band, dt=0.05, maxstep=0.1)
        opt.run(fmax=fmax, steps=500)

    from ..io.xyz import write_xyz
    from ..system import SinglePointCalculator

    out = []
    for im in images:
        snap = im.copy()
        snap.calc = SinglePointCalculator(
            snap, energy=im.get_potential_energy(), forces=im.get_forces()
        )
        out.append(snap)
    write_xyz(trajectory, out)
    return band


def main():
    import argparse

    from ..io.xyz import read_xyz

    parser = argparse.ArgumentParser(description="ML NEB")
    parser.add_argument("-i", "--input", required=True,
                        help="extxyz with 2 endpoints or a full band")
    args = parser.parse_args()
    cline.refresh()
    images = read_xyz(args.input)
    kwargs = cline.get_default_args(neb)
    cline.update_args(kwargs)
    band = neb(images, **kwargs)
    print(f"barrier: {band.barrier()} eV")


if __name__ == "__main__":
    main()
