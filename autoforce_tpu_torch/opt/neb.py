"""Nudged elastic band with improved tangents and optional climbing image.

Role of ase.mep.NEB in theforce/cl/neb.py: find minimum-energy paths and
barriers with the (ML) calculator.  Improved-tangent NEB after Henkelman &
Jonsson, JCP 113, 9978 (2000); climbing image after JCP 113, 9901 (2000).

A copy of ``autoforce_tpu/opt/neb.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def interpolate_images(first, last, nimages):
    """Linear interpolation between two endpoint systems (inclusive)."""
    images = []
    for k in range(nimages):
        t = k / (nimages - 1)
        s = first.copy()
        s.set_positions((1 - t) * first.positions + t * last.positions)
        images.append(s)
    return images


class NEB:
    def __init__(self, images, k=0.1, climb=False):
        self.images = images
        self.k = k
        self.climb = climb
        self.energies = None

    def __len__(self):
        return (len(self.images) - 2) * len(self.images[0])

    # ---- optimizer protocol over the interior images ----
    def get_positions(self):
        return np.concatenate([im.positions for im in self.images[1:-1]])

    def set_positions(self, x):
        n = len(self.images[0])
        for i, im in enumerate(self.images[1:-1]):
            im.set_positions(x[i * n : (i + 1) * n])

    def get_potential_energy(self):
        self._compute()
        return float(max(self.energies))

    def get_forces(self):
        self._compute()
        nim = len(self.images)
        n = len(self.images[0])
        E = self.energies
        out = []
        imax = int(np.argmax(E))
        for i in range(1, nim - 1):
            t = self._tangent(i)
            f = self.forces_raw[i]
            f_par = (f * t).sum() * t
            f_perp = f - f_par
            # spring force along tangent
            dp = np.linalg.norm(
                self.images[i + 1].positions - self.images[i].positions
            )
            dm = np.linalg.norm(
                self.images[i].positions - self.images[i - 1].positions
            )
            f_spring = self.k * (dp - dm) * t
            if self.climb and i == imax:
                out.append(f - 2.0 * f_par)
            else:
                out.append(f_perp + f_spring)
        return np.concatenate(out)

    def _compute(self):
        self.energies = [im.get_potential_energy() for im in self.images]
        self.forces_raw = {
            i: self.images[i].get_forces() for i in range(1, len(self.images) - 1)
        }

    def _tangent(self, i):
        """Improved tangent estimate (Henkelman-Jonsson)."""
        E = self.energies
        rm = self.images[i - 1].positions
        r0 = self.images[i].positions
        rp = self.images[i + 1].positions
        tp = rp - r0
        tm = r0 - rm
        if E[i + 1] > E[i] > E[i - 1]:
            t = tp
        elif E[i + 1] < E[i] < E[i - 1]:
            t = tm
        else:
            dEmax = max(abs(E[i + 1] - E[i]), abs(E[i - 1] - E[i]))
            dEmin = min(abs(E[i + 1] - E[i]), abs(E[i - 1] - E[i]))
            if E[i + 1] > E[i - 1]:
                t = tp * dEmax + tm * dEmin
            else:
                t = tp * dEmin + tm * dEmax
        norm = np.linalg.norm(t)
        return t / (norm + 1e-30)

    def barrier(self):
        self._compute()
        return max(self.energies) - self.energies[0]
