"""Trajectory statistics (counterpart of theforce/analysis/analysis.py):
displacements, mean-squared displacement, diffusion, Arrhenius fits.

A copy of ``autoforce_tpu/analysis/trajectory.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .. import units


class TrajAnalyser:
    def __init__(self, frames):
        """frames: list of Systems (same atom count/order)."""
        self.frames = frames
        self.numbers = frames[0].numbers

    def __len__(self):
        return len(self.frames)

    def select(self, species=None):
        if species is None:
            return np.arange(len(self.numbers))
        return np.flatnonzero(self.numbers == species)

    def positions(self, species=None):
        i = self.select(species)
        return np.stack([f.positions[i] for f in self.frames])  # (T, n, 3)

    def displacements(self, species=None, unwrap=True):
        """Unwrapped displacements from the first frame (minimum-image
        increments accumulated along the trajectory)."""
        pos = self.positions(species)
        if not unwrap:
            return pos - pos[0]
        out = np.zeros_like(pos)
        for t in range(1, len(pos)):
            d = pos[t] - pos[t - 1]
            cell = self.frames[t].cell
            if self.frames[t].pbc.any():
                frac = np.linalg.solve(cell.T, d.reshape(-1, 3).T).T
                frac -= np.round(frac)
                d = (frac @ cell).reshape(d.shape)
            out[t] = out[t - 1] + d
        return out

    def msd(self, species=None):
        """Mean-squared displacement vs frame index."""
        disp = self.displacements(species)
        return (disp**2).sum(axis=-1).mean(axis=-1)

    def diffusion_constant(self, dt_fs, species=None, fit_from=0.5):
        """D in A^2/fs from the slope of MSD = 6 D t."""
        m = self.msd(species)
        t = np.arange(len(m)) * dt_fs
        i0 = int(len(m) * fit_from)
        if len(m) - i0 < 2:
            i0 = 0
        slope = np.polyfit(t[i0:], m[i0:], 1)[0]
        return slope / 6.0

    def temperatures(self):
        return np.array([f.get_temperature() for f in self.frames])

    # ----------------------------------------- sampled-pair statistics
    # (reference analysis.py:64-212: get_rand_pair / ave_vol /
    #  hist_rtp_displacements / center_of_mass / get_scalars)
    def get_pair(self, i, j):
        return self.frames[i], self.frames[j]

    def sample_pairs(self, delta, sample_size=100, rng=None):
        """Random frame pairs (t, t+delta) — the reference's Sampler +
        get_rand_pair loop (analysis.py:64-75)."""
        rng = np.random.default_rng(rng)
        hi = len(self.frames) - delta
        if hi <= 0:
            raise ValueError(f"delta={delta} >= trajectory length")
        for _ in range(sample_size):
            t = int(rng.integers(0, hi))
            yield self.frames[t], self.frames[t + delta]

    def get_scalars(self, prop=("volume",)):
        """Per-frame scalar properties, e.g. ('volume', 'temperature')
        (analysis.py:88-92)."""
        cols = []
        for f in self.frames:
            row = []
            for q in prop:
                row.append(
                    getattr(f, q) if hasattr(f, q)
                    else getattr(f, f"get_{q}")()
                )
            cols.append(row)
        return tuple(np.array(c) for c in zip(*cols))

    def center_of_mass(self, species=None):
        """Summed positions of the selection per frame
        (analysis.py:94-99)."""
        i = self.select(species)
        return np.stack([f.positions[i].sum(axis=0) for f in self.frames])

    def ave_vol(self, sample_size=100, rng=None):
        """(mean, variance) of the cell volume over random frames
        (analysis.py:101-106)."""
        rng = np.random.default_rng(rng)
        t = rng.integers(0, len(self.frames), sample_size)
        v = np.array([self.frames[k].volume for k in t])
        return float(v.mean()), float(v.var())

    def hist_rtp_displacements(self, delta, rmax=10.0, bins=(100, 30, 60),
                               species=None, sample_size=100, rng=None):
        """Spherical (r, theta, phi) histogram of atomic displacements
        over ``delta`` frames (analysis.py:166-197): returns bin centers
        (r, t, p), the per-atom-normalized histogram, and the number
        density of the selection."""
        i = self.select(species)
        edges = [
            np.linspace(0, rmax, bins[0]),
            np.linspace(0, np.pi, bins[1]),
            np.linspace(-np.pi, np.pi, bins[2]),
        ]
        h = np.zeros(tuple(np.array(bins) - 1))
        vols = []
        for a, b in self.sample_pairs(delta, sample_size, rng):
            vols += [a.volume, b.volume]
            d = (b.positions[i] - a.positions[i]).reshape(-1, 3)
            r = np.linalg.norm(d, axis=-1)
            theta = np.arccos(
                np.clip(np.divide(d[:, 2], r, out=np.zeros_like(r),
                                  where=r > 0), -1, 1)
            )
            phi = np.arctan2(d[:, 1], d[:, 0])
            h += np.histogramdd(np.stack([r, theta, phi], axis=1),
                                bins=edges)[0]
        centers = tuple(e[:-1] + (e[1] - e[0]) / 2 for e in edges)
        n = len(i)
        h /= n * sample_size
        rho = n / np.array(vols).mean()
        return (*centers, h, rho)

    def energies(self):
        return np.array(
            [f.calc.results.get("energy", np.nan) if f.calc else np.nan
             for f in self.frames]
        )


def arrhenius_fit(temperatures, diffusions):
    """ln D = ln D0 - Ea/(kB T): returns (Ea [eV], D0)."""
    x = 1.0 / (units.kB * np.asarray(temperatures, dtype=float))
    y = np.log(np.asarray(diffusions, dtype=float))
    slope, intercept = np.polyfit(x, y, 1)
    return -slope, float(np.exp(intercept))
