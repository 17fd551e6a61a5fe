"""Seed a model from rattled copies of a structure (port of
``autoforce_tpu/cl/init_model.py``, counterpart of
theforce/cl/init_model.py): ``python -m autoforce_tpu_torch.cl.init_model
-i POSCAR -n 5 -r 0.05``."""

from __future__ import annotations

import numpy as np

from .. import cl as cline


def init_model(atoms, samples=5, rattle=0.05):
    calc = cline.gen_active_calc()
    rng = np.random.default_rng()
    for _ in range(samples):
        s = atoms.copy()
        s.positions = s.positions + rng.uniform(-rattle, rattle, s.positions.shape)
        s.calc = calc
        s.get_potential_energy()
    calc.save_model()
    return calc


def main():
    import argparse

    from ..io.poscar import read_structure

    parser = argparse.ArgumentParser(description="Seed a model")
    parser.add_argument("-i", "--input", default="POSCAR")
    parser.add_argument("-n", "--samples", type=int, default=5)
    parser.add_argument("-r", "--rattle", type=float, default=0.05)
    args = parser.parse_args()
    cline.refresh()
    init_model(read_structure(args.input), args.samples, args.rattle)


if __name__ == "__main__":
    main()
