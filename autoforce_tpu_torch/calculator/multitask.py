"""Multi-task active calculator: learn several PES at once (port of
``autoforce_tpu/calculator/multitask.py``).

Counterpart of theforce/calculator/active_multi_task.py: one kernel /
inducing set, multiple oracle calculators (tasks); predictions are
weighted combinations (e.g. thermodynamic-integration schedules); the
sampling machinery is inherited unchanged.
"""

from __future__ import annotations

import numpy as np

from ..regression.multitask import MultiTaskRecord, MultiTaskSgprModel
from .active import ActiveCalculator, default_kernel_engine


class MultiTaskCalculator(ActiveCalculator):
    # per-task energies are computed from the covariance block every step
    # (predict_task_energies below), including inference-only runs
    _always_fetch_cov = True

    def __init__(self, calculators, weights=None, kernel_kw=None,
                 tasks_kern_optimization=False, niter_tasks=2,
                 weights_fin=None, weights_sample=None, t_tieq=200000,
                 k=1.0, d0=1.0, ij=None, device="cuda", dtype=None, **kw):
        self.calcs = list(calculators)
        tasks = len(self.calcs)
        self.weights = (
            np.asarray(weights, dtype=float)
            if weights is not None
            else np.ones(tasks) / tasks
        )
        # thermodynamic integration endpoint + weights-space sampling
        # cadence + QMMM harmonic bond restraints
        # (active_multi_task.py:120-194)
        self.weights_init = self.weights.copy()
        self.weights_fin = (
            None
            if weights_fin is None
            else np.asarray(weights_fin, dtype=float)
            / np.asarray(weights_fin, dtype=float).sum()
        )
        self.weights_sample = weights_sample
        self.t_tieq = int(t_tieq)
        self.bond_k = float(k)
        self.bond_d0 = float(d0)
        self.ij = ij
        engine = default_kernel_engine(**(kernel_kw or {}), device=device,
                                       dtype=dtype)
        model = MultiTaskSgprModel(
            engine, tasks,
            tasks_kern_optimization=tasks_kern_optimization,
            niter_tasks=niter_tasks,
        )
        kw.setdefault("covariance", model)
        super().__init__(calculator=self.calcs[0], kernel_kw=kernel_kw,
                         device=device, dtype=dtype, **kw)

    @property
    def tasks(self):
        return self.model.tasks

    def set_weights(self, weights):
        """e.g. thermodynamic integration schedule
        (active_multi_task.py:183-194)."""
        self.weights = np.asarray(weights, dtype=float)
        if self.model.multi_mu is not None:
            self.model.mu = self.model.effective_mu(self.weights)
            self.model._model_arrays = None

    def _predict(self):
        model = self.model
        if model.multi_mu is not None:
            mu = model.effective_mu(self.weights)
            if not np.array_equal(mu, model.mu):
                # the staged device arrays hold the old mu: restage them
                model.mu = mu
                model._model_arrays = None
        res = super()._predict()
        if self.model.multi_mu is not None:
            res["energy"] = float(
                res["energy"]
                + self.model.effective_shift(self.weights, self.system.numbers)
            )
            # per-task energies for observers
            res["task_energies"] = self.model.predict_task_energies(
                self._cov, self.system.numbers
            )
            self.results = res
        return res

    # ------------------------------------------------- QMMM bond restraints
    def _mic_vector(self, i, j):
        """Minimum-image displacement r_j - r_i of the current system."""
        s = self.system
        r = s.positions[j] - s.positions[i]
        if s.pbc.any() and abs(np.linalg.det(s.cell)) > 1e-12:
            f = np.linalg.solve(s.cell.T, r)
            f -= np.where(s.pbc, np.rint(f), 0.0)
            r = f @ s.cell
        return r

    def _apply_restraints(self):
        """Harmonic bond restraints added on top of every task
        (active_multi_task.py:120-135): e += 2 k (d-d0)^2 per pair,
        with the matching pair forces."""
        if self.ij is None or len(self.ij) == 0:
            return
        de = 0.0
        forces = np.array(self.results["forces"], copy=True)
        self.results["forces"] = forces
        for a, b in self.ij:
            r = self._mic_vector(a, b)
            d = float(np.linalg.norm(r))
            e = self.bond_k * (d - self.bond_d0) ** 2
            f = -2.0 * self.bond_k * (d - self.bond_d0) / max(d, 1e-12) * r
            de += 2.0 * e
            forces[a] -= f
            forces[b] += f
        self.results["energy"] = self.results["energy"] + de
        if "task_energies" in self.results:
            self.results["task_energies"] = (
                np.asarray(self.results["task_energies"]) + de
            )

    def post_calculate(self, timings):
        self._apply_restraints()
        super().post_calculate(timings)
        # weights-space sampling: jump to a random one-hot different from
        # the current weights, for even coverage of the weight simplex
        # (active_multi_task.py:167-181)
        if (
            self.weights_sample is not None
            and self.step > 0
            and self.step % self.weights_sample == 0
        ):
            self.sample_weights_space()
        # thermodynamic integration: walk weights_init -> weights_fin on a
        # 10-point lambda grid, one point per t_tieq steps (:183-194)
        if self.weights_fin is not None and self.step % self.t_tieq == 0:
            self.thermo_int()

    def sample_weights_space(self):
        """Jump to a one-hot over a task with zero current weight
        (reference even-sampling rule); if every task already has weight
        (e.g. uniform start), any other task qualifies."""
        T = len(self.calcs)
        zero = np.flatnonzero(self.weights == 0.0)
        cand = zero if len(zero) else np.flatnonzero(
            np.arange(T) != int(self.weights.argmax())
        )
        if not len(cand):
            return
        update = np.zeros(T)
        update[self.rng.choice(cand)] = 1.0
        self.set_weights(update)
        self.log(f"weights sample: w={self.weights}")

    def thermo_int(self):
        ti_ngrid = 10
        lam = min(round(self.step / (self.t_tieq * ti_ngrid), 1), 1.0)
        self.set_weights(
            (1.0 - lam) * self.weights_init + lam * self.weights_fin
        )
        self.log(f"thermodynamic integration: lambda={lam} w={self.weights}")

    def snapshot(self, fake=False) -> MultiTaskRecord:
        copy = self.system.copy()
        if fake:
            T = self.tasks
            e = self.results.get(
                "task_energies", np.full(T, self.results["energy"])
            )
            f = np.repeat(self.results["forces"][None], T, axis=0)
            rec = MultiTaskRecord(
                system=copy, e=np.asarray(e, dtype=float), f=f,
                s=np.zeros((T, 6)), natoms=len(copy),
            )
            return rec
        energies = []
        forces = []
        stresses = []
        for calc in self.calcs:
            tmp = copy.copy()
            tmp.calc = calc
            energies.append(tmp.get_potential_energy())
            forces.append(tmp.get_forces())
            try:
                stresses.append(tmp.get_stress())
            except Exception:
                stresses.append(np.zeros(6))
        if self.tape:
            from ..system import SinglePointCalculator

            tmp = copy.copy()
            tmp.calc = SinglePointCalculator(
                tmp, energy=energies[0], forces=forces[0], stress=stresses[0]
            )
            self._saved_for_tape = tmp
        self.log(f"exact energies: {energies}")
        self._last_test = self.step
        return MultiTaskRecord.from_results(copy, energies, forces, stresses)

    def head(self):
        rec = self.model.data[-1]
        new = self.snapshot(fake=False)
        rec.e, rec.f, rec.s = new.e, new.f, new.s
        self.model.touch_targets()
        self.model.make_munu()

    def add_1atoms_fast(self, rec):
        model = self.model
        if model.ndata == 0:
            model.add_data(rec)
            return 1, np.inf, np.inf
        e1, f1 = self._fast_ef()
        model.add_data(rec)
        model.mu = model.effective_mu(self.weights)
        model._model_arrays = None
        e2, f2 = self._fast_ef()
        fdiff = self.fdiff
        d = (f2 - f1).reshape(-1)
        df = np.abs(d).mean() if d.size else 0.0
        reject = (
            fdiff < np.inf
            and (d * d).mean() < fdiff**2
            and np.abs(d).max() < 3 * fdiff
        )
        blind = abs(e1) < 1e-8 and abs(e2) < 1e-8
        if reject and not blind:
            model.pop_1data()
            return 0, abs(e1 - e2), df
        return 1, abs(e1 - e2), df
