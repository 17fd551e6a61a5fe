"""Physical units for the eV / Angstrom / amu system.

The internal unit system matches the reference stack's (ASE) conventions:
energy in eV, length in Angstrom, mass in amu.  The derived internal time
unit is Ang*sqrt(amu/eV); `fs` converts femtoseconds into internal time.

Values derived from CODATA 2018 (scipy.constants).
"""

import math

# base
Ang = Angstrom = 1.0
eV = 1.0
amu = 1.0

# CODATA 2018
_e = 1.602176634e-19  # C
_amu = 1.66053906660e-27  # kg
_kB = 1.380649e-23  # J/K
_hbar = 1.054571817e-34  # J s

# derived
kB = _kB / _e  # eV/K  (= 8.617333262e-5)
# internal time unit in seconds: Ang * sqrt(amu/eV)
_t_internal = 1e-10 * math.sqrt(_amu / _e)
second = 1.0 / _t_internal
fs = 1e-15 * second  # ~0.098226...
ps = 1e-12 * second

GPa = 1e9 / (_e * 1e30)  # eV/Ang^3 per GPa
bar = 1e-4 * GPa
Pascal = 1e-9 * GPa

kcal_mol = 0.0433641  # eV (thermochemical kcal/mol)
Hartree = 27.211386245988
Bohr = 0.529177210903
Rydberg = Hartree / 2
Debye = 0.2081943  # e*Ang
