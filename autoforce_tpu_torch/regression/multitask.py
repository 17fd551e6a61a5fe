"""Multi-task SGPR: several PES learned with one kernel.

Port of ``autoforce_tpu/regression/multitask.py`` (numpy and scipy,
as there), the counterpart of the reference's MultiTaskPotential
(theforce/regression/multi_task.py): the covariance matrix is the
Kronecker product of the configuration kernel with a tasks x tasks
correlation kernel W = L L^T; per-species constant energy shifts are
solved jointly as extra linear columns; optionally W is optimized by
alternating least squares (2-task case).

The Kronecker solve is organized so per-task predictions reduce to the
standard single-task device path with effective weights
``nu_t[j] = (W @ mu_j)_t``, so the card serves the combined surface
through the same kernels as one model.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize

from .sgpr import DataRecord, SgprModel


class MultiTaskRecord(DataRecord):
    """Targets with a leading task axis: e (T,), f (T,n,3), s (T,6)."""

    @classmethod
    def from_results(cls, system, energies, forces, stresses=None):
        T = len(energies)
        n = len(system)
        s = np.zeros((T, 6)) if stresses is None else np.asarray(stresses)
        return cls(
            system=system.copy(),
            e=np.asarray(energies, dtype=float),
            f=np.asarray(forces, dtype=float).reshape(T, n, 3),
            s=s,
            natoms=n,
        )


class MultiTaskSgprModel(SgprModel):
    def __init__(self, engine, tasks, tasks_kern_optimization=False,
                 niter_tasks=2, sigma=0.01, **kw):
        super().__init__(engine, **kw)
        self.tasks = int(tasks)
        self.tasks_kern_L = np.eye(self.tasks) + 1e-2
        self.tasks_kern = np.eye(self.tasks)
        self.tasks_kern_optimization = tasks_kern_optimization
        self.niter_tasks = niter_tasks
        self.sigma = sigma
        self.multi_mu = None
        self.multi_types = {}

    # ----------------------------------------------------------------- solve
    def _design(self):
        """kern = [Ke; Kf; sigma L^T] plus per-species count columns."""
        atom_types = sorted(
            {int(z) for rec in self.data for z in rec.system.numbers_set()}
        )
        ntypes = len(atom_types)
        n = self.ndata
        counts = np.zeros((n, ntypes))
        for i, rec in enumerate(self.data):
            c = rec.system.counts()
            for j, z in enumerate(atom_types):
                counts[i, j] = c.get(z, 0)
        kern1 = np.concatenate([self.Ke, self.Kf], axis=0)
        kern2 = np.concatenate(
            [counts, np.zeros((self.Kf.shape[0], ntypes))], axis=0
        )
        kern = np.concatenate([kern1, kern2], axis=1)
        # sgpr regularization rows (multi_task.py:85-95)
        L = np.linalg.cholesky(
            self.M + 1e-10 * np.eye(self.m)
        )
        reg = np.concatenate(
            [self.sigma * L.T, np.zeros((self.m, ntypes))], axis=1
        )
        kern = np.concatenate([kern, reg], axis=0)
        return kern, atom_types, L

    def _targets_flat(self):
        """[energies; forces] with the task axis fastest (kron ordering)."""
        e = np.concatenate([rec.e.reshape(-1) for rec in self.data])
        f = np.concatenate(
            [rec.f.transpose(1, 2, 0).reshape(-1) for rec in self.data]
        )
        return np.concatenate([e, f])

    def make_munu(self, optimize=False, noise_f=0.0):
        if self.m == 0 or self.ndata == 0:
            return
        kern, atom_types, L = self._design()
        self.multi_types = {z: i for i, z in enumerate(atom_types)}
        targets = self._targets_flat()
        size = targets.size
        targets = np.concatenate([targets, np.zeros(self.m * self.tasks)])

        def solve(W):
            design = np.kron(kern, W)
            sol, *_ = np.linalg.lstsq(design, targets, rcond=None)
            pred = design @ sol
            return sol, pred

        if self.tasks_kern_optimization and self.tasks == 2:
            sol, pred = solve(self.tasks_kern)
            for _ in range(self.niter_tasks):
                x0 = [self.tasks_kern_L[0, 0], self.tasks_kern_L[1, 0],
                      self.tasks_kern_L[1, 1]]

                def obj(x):
                    Lw = np.array([[x[0], 0.0], [x[1], x[2]]])
                    W = Lw @ Lw.T
                    pred = np.kron(kern, W) @ sol
                    return np.abs(pred - targets).mean()

                res = minimize(obj, x0)
                self.tasks_kern_L = np.array(
                    [[res.x[0], 0.0], [res.x[1], res.x[2]]]
                )
                self.tasks_kern = self.tasks_kern_L @ self.tasks_kern_L.T
                sol, pred = solve(self.tasks_kern)
        else:
            self.tasks_kern = np.eye(self.tasks)
            sol, pred = solve(self.tasks_kern)

        self.multi_mu = sol
        self.scaled_noise = {"all": self.sigma}
        self.ridge = 0.0
        self.choli = np.linalg.inv(L)
        split = self.m * self.tasks
        self.mu_tasks = sol[:split].reshape(self.m, self.tasks)
        self.shift_tasks = sol[split:].reshape(len(atom_types), self.tasks)
        # single-task-equivalent weights for device prediction (task-summed
        # with uniform weights by default; calculator overrides per task)
        self.mu = self.effective_mu(np.ones(self.tasks) / self.tasks)
        self._make_multi_stats(targets[:size], pred[:size])
        self._model_arrays = None

    def _solve_state(self):
        """Extend the trial-addition snapshot with the multi-task solve
        fields (sgpr.add_1inducing restores on reject; the base tuple
        alone would leave (m+1)-row mu_tasks against an m-column model)."""
        def cp(a):
            return None if a is None else np.array(a, copy=True)

        return (
            super()._solve_state(), cp(self.multi_mu),
            cp(getattr(self, "mu_tasks", None)),
            cp(getattr(self, "shift_tasks", None)),
            cp(self.tasks_kern), cp(self.tasks_kern_L),
            dict(self.multi_types),
        )

    def _restore_solve_state(self, saved):
        (base, self.multi_mu, self.mu_tasks, self.shift_tasks,
         self.tasks_kern, self.tasks_kern_L, self.multi_types) = saved
        super()._restore_solve_state(base)

    def effective_mu(self, weights):
        """nu[j] = sum_t w_t (W @ mu_j)_t: plugs into the standard device
        predict as mu."""
        Wmu = self.mu_tasks @ self.tasks_kern.T  # (m, T)
        return Wmu @ np.asarray(weights)

    def effective_shift(self, weights, numbers):
        Ws = self.shift_tasks @ self.tasks_kern.T  # (ntypes, T)
        shift = Ws @ np.asarray(weights)
        e = 0.0
        for z in np.asarray(numbers):
            i = self.multi_types.get(int(z))
            if i is not None:
                e += shift[i]
        return float(e)

    def predict_task_energies(self, cov, numbers):
        """(T,) energies from a host covariance row block
        (multi_task.py:163-176)."""
        Wmu = self.mu_tasks @ self.tasks_kern.T  # (m, T)
        e = cov @ Wmu  # (n, T)
        out = e.sum(axis=0)
        Ws = self.shift_tasks @ self.tasks_kern.T
        for z in np.asarray(numbers):
            i = self.multi_types.get(int(z))
            if i is not None:
                out = out + Ws[i]
        return out

    def _make_multi_stats(self, y, yy):
        nT = self.ndata * self.tasks
        diff = yy - y
        natoms = np.repeat(
            [rec.natoms for rec in self.data], self.tasks
        ).astype(float)
        ediff = diff[:nT] / natoms
        fdiff = diff[nT:]
        ss_res = ((yy[nT:] - y[nT:]) ** 2).sum()
        ss_tot = ((y[nT:] - y[nT:].mean()) ** 2).sum()
        self.stats = dict(
            e_mean=float(ediff.mean()),
            e_mae=float(np.abs(ediff).mean()),
            f_mean=float(fdiff.mean()) if len(fdiff) else 0.0,
            f_mae=float(np.abs(fdiff).mean()) if len(fdiff) else 0.0,
            r2=float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0,
        )
        q = (self.mu_tasks * (self.M @ self.mu_tasks)).sum(axis=1)
        numbers = np.array([x.number for x in self.X])
        self.vscale = {}
        self.indu_counts = {}
        for z in np.unique(numbers):
            sel = numbers == z
            self.vscale[int(z)] = float(q[sel].sum() / sel.sum())
            self.indu_counts[int(z)] = int(sel.sum())

    def mean_energy(self, numbers):
        # the per-species shift is inside the multi-task solution
        return 0.0
