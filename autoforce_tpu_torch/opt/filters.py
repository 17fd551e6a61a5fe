"""Variable-cell relaxation filter (role of ase.constraints.UnitCellFilter
in theforce/cl/relax.py:34-41).

A copy of ``autoforce_tpu/opt/filters.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

import numpy as np


class UnitCellFilter:
    """Exposes positions + cell strain as one optimization vector.

    Extra 3 rows appended to positions hold the (scaled) deformation
    gradient; their 'forces' are the negative stress * volume so that a
    zero-force optimum is a zero-stress cell.
    """

    def __init__(self, system, scalar_pressure=0.0, cell_factor=None):
        self.system = system
        self.pressure = scalar_pressure
        self.cell0 = system.cell.copy()
        self.cell_factor = cell_factor or float(len(system))
        self.deform = np.eye(3)

    def __len__(self):
        return len(self.system) + 3

    def get_positions(self):
        pos = np.linalg.solve(
            self.deform.T, self.system.positions.T
        ).T  # undeformed coords
        return np.concatenate([pos, self.deform * self.cell_factor])

    def set_positions(self, x):
        n = len(self.system)
        pos_und = x[:n]
        self.deform = x[n:] / self.cell_factor
        self.system.set_cell(self.cell0 @ self.deform.T)
        self.system.set_positions(pos_und @ self.deform.T)

    def get_forces(self):
        f = self.system.get_forces()
        st = self.system.get_stress()  # Voigt
        stress = np.array(
            [
                [st[0], st[5], st[4]],
                [st[5], st[1], st[3]],
                [st[4], st[3], st[2]],
            ]
        )
        stress = stress + self.pressure * np.eye(3)
        vol = self.system.volume
        virial = -vol * stress
        # forces on the deformation DOF
        f_und = f @ self.deform  # transform to undeformed frame (approx)
        return np.concatenate([f_und, virial / self.cell_factor])

    def get_potential_energy(self):
        return self.system.get_potential_energy() + self.pressure * self.system.volume
