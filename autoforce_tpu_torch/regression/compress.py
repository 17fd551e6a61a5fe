"""Offline model compression: inducing-set shrinking.

A copy of ``autoforce_tpu/regression/compress.py`` on this package's
:class:`~autoforce_tpu_torch.regression.sgpr.SgprModel`: counterparts of
the reference's greedy force-R2 shrink (theforce/cl/shrink.py:10-35) and
randomized sparser_projection (theforce/regression/algebra.py:154-179,
sparsify.py): reduce the inducing set while monitoring the force fit.

Both work on the model's host arrays (``M``, ``Ke``, ``Kf``, ``Kv``, solved
by :func:`solver.solve_sgpr`) and end in ``SgprModel.select_inducing``,
which drops the model's staged device arrays: the next prediction restages
the smaller model on its device.
"""

from __future__ import annotations

import numpy as np

from . import solver


def _force_r2(model, keep):
    """Force R2 after restricting the model to inducing subset ``keep``."""
    keep = np.asarray(keep, dtype=int)
    M = model.M[np.ix_(keep, keep)]
    Ke = model.Ke[:, keep]
    Kf = model.Kf[:, keep]
    Kv = model.Kv[:, keep]
    energies, forces, virials = model.targets()
    zlist, C = model.species_count_matrix()
    natoms = np.array([rec.natoms for rec in model.data])
    res = solver.solve_sgpr(
        M, Ke, Kf, Kv, energies, forces, virials, natoms, C,
        model.noise_state, model.mean_weights,
    )
    pred = Kf @ res.mu
    ss_res = ((pred - forces) ** 2).sum()
    ss_tot = ((forces - forces.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


def shrink(model, target_m, candidates=None, verbose=False):
    """Greedy removal of least-important inducing points by force R2."""
    keep = list(range(model.m))
    while len(keep) > target_m:
        cand = keep if candidates is None else list(
            np.random.default_rng().choice(keep, min(candidates, len(keep)),
                                           replace=False)
        )
        best_r2, best_j = -np.inf, None
        for j in cand:
            trial = [k for k in keep if k != j]
            r2 = _force_r2(model, trial)
            if r2 > best_r2:
                best_r2, best_j = r2, j
        keep.remove(best_j)
        if verbose:
            print(f"m={len(keep)}  R2={best_r2:.6f}")
    model.select_inducing(keep)
    return keep


def sparsify(model, sweeps=1.0, alpha=1.0, seed=None):
    """Randomized removal accepted when max|error| and error variance do
    not grow (sparser_projection, algebra.py:154-179)."""
    rng = np.random.default_rng(seed)
    energies, forces, virials = model.targets()
    keep = list(range(model.m))

    def errors(subset):
        pred = model.Kf[:, subset] @ _solve(subset)
        delta = pred - forces
        return np.abs(delta).max(), delta.var()

    def _solve(subset):
        sub = np.asarray(subset, dtype=int)
        zlist, C = model.species_count_matrix()
        natoms = np.array([rec.natoms for rec in model.data])
        res = solver.solve_sgpr(
            model.M[np.ix_(sub, sub)], model.Ke[:, sub], model.Kf[:, sub],
            model.Kv[:, sub], energies, forces, virials, natoms, C,
            model.noise_state, model.mean_weights,
        )
        return res.mu

    dmax, var = errors(keep)
    for _ in range(int(len(keep) * sweeps)):
        if len(keep) <= 1:
            break
        j = keep[rng.integers(len(keep))]
        trial = [k for k in keep if k != j]
        d2, v2 = errors(trial)
        if d2 <= dmax and v2 <= alpha * var:
            keep = trial
            dmax, var = d2, v2
    model.select_inducing(keep)
    return keep
