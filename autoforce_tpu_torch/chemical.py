"""Alchemical similarity between chemical species (copy of
``autoforce_tpu/chemical.py``; numpy only).

Counterpart of the reference's ChemRBF / ChemicalSoapKernel
(theforce/similarity/chemical.py, data.py): species correlate through an
RBF over element-property embeddings instead of a Dirac delta, so the
model can share information between chemically similar elements.

    chi(a, b) = exp(-||e_a - e_b||^2),  e = variance-normalized
                [vdW radius (pm), Pauling electronegativity,
                 electron affinity (eV)]

(the reference pulls the same three columns from the mendeleev package,
which is not installed here; the values below are the standard published
element properties).  In the kernel the reference applies chi twice: as a
central-species factor and as a species-pair-block mixing inside the
descriptor dot product (chemical.py:34-53).  Here the mixing is a linear
map on the species axes of the power spectrum — p~ = (L (x) L) p with
L = chol(chi_S) — after which the standard (p~ . q~)^zeta machinery
applies unchanged.
"""

from __future__ import annotations

import numpy as np

# Z: (vdW radius [pm], Pauling EN, electron affinity [eV]); 0.0 = unknown
_PROPS = {
    1: (120, 2.20, 0.754), 2: (140, 0.0, 0.0),
    3: (182, 0.98, 0.618), 4: (153, 1.57, 0.0), 5: (192, 2.04, 0.280),
    6: (170, 2.55, 1.262), 7: (155, 3.04, 0.0), 8: (152, 3.44, 1.461),
    9: (147, 3.98, 3.401), 10: (154, 0.0, 0.0),
    11: (227, 0.93, 0.548), 12: (173, 1.31, 0.0), 13: (184, 1.61, 0.433),
    14: (210, 1.90, 1.390), 15: (180, 2.19, 0.746), 16: (180, 2.58, 2.077),
    17: (175, 3.16, 3.613), 18: (188, 0.0, 0.0),
    19: (275, 0.82, 0.501), 20: (231, 1.00, 0.025),
    21: (215, 1.36, 0.188), 22: (211, 1.54, 0.079), 23: (207, 1.63, 0.525),
    24: (206, 1.66, 0.666), 25: (205, 1.55, 0.0), 26: (204, 1.83, 0.151),
    27: (200, 1.88, 0.662), 28: (197, 1.91, 1.156), 29: (196, 1.90, 1.235),
    30: (201, 1.65, 0.0), 31: (187, 1.81, 0.430), 32: (211, 2.01, 1.233),
    33: (185, 2.18, 0.804), 34: (190, 2.55, 2.021), 35: (185, 2.96, 3.364),
    36: (202, 3.00, 0.0),
    37: (303, 0.82, 0.486), 38: (249, 0.95, 0.048),
    39: (232, 1.22, 0.307), 40: (223, 1.33, 0.426), 41: (218, 1.60, 0.893),
    42: (217, 2.16, 0.748), 43: (216, 1.90, 0.55), 44: (213, 2.20, 1.05),
    45: (210, 2.28, 1.137), 46: (210, 2.20, 0.562), 47: (211, 1.93, 1.302),
    48: (218, 1.69, 0.0), 49: (193, 1.78, 0.3), 50: (217, 1.96, 1.112),
    51: (206, 2.05, 1.046), 52: (206, 2.10, 1.971), 53: (198, 2.66, 3.059),
    54: (216, 2.60, 0.0),
    55: (343, 0.79, 0.472), 56: (268, 0.89, 0.145),
    57: (243, 1.10, 0.47), 58: (242, 1.12, 0.65), 72: (223, 1.30, 0.0),
    73: (222, 1.50, 0.322), 74: (218, 2.36, 0.815), 75: (216, 1.90, 0.15),
    76: (216, 2.20, 1.1), 77: (213, 2.20, 1.564), 78: (213, 2.28, 2.128),
    79: (214, 2.54, 2.309), 80: (223, 2.00, 0.0), 81: (196, 1.62, 0.377),
    82: (202, 2.33, 0.356), 83: (207, 2.02, 0.942),
}

ZMAX = 119


def atom_embeddings(normalize=True):
    """(Z-indexed embedding matrix) with variance normalization
    (reference data.py:7-18)."""
    em = np.zeros((ZMAX, 3))
    for z, props in _PROPS.items():
        em[z] = props
    if normalize:
        known = np.array(sorted(_PROPS.keys()))
        std = em[known].std(axis=0)
        std[std == 0] = 1.0
        em = em / std
    return em


def chem_rbf_table(embeddings=None):
    """(ZMAX, ZMAX) chi(a,b) = exp(-||e_a - e_b||^2) (chemical.py:21-25)."""
    em = atom_embeddings() if embeddings is None else embeddings
    d2 = ((em[:, None, :] - em[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2)


def mixing_cholesky(species, table=None):
    """L with L L^T = chi restricted to the model species table; applied
    to the species axes of the power spectrum so that
    (p~ . q~) = sum_{ab,a'b'} chi_aa' chi_bb' p_ab q_a'b'."""
    chi = chem_rbf_table() if table is None else table
    sub = chi[np.ix_(species, species)]
    # jitter for numerically repeated embeddings
    L = np.linalg.cholesky(sub + 1e-10 * np.eye(len(species)))
    return L
