"""On-the-fly active-learning calculator (port of
``autoforce_tpu/calculator/active.py``).

The counterpart of the reference's ``ActiveCalculator``
(theforce/calculator/active.py:104-1149): an ASE-protocol calculator that
serves SGPR predictions from the device engine and, when an ab-initio
("oracle") calculator is attached, samples new inducing environments and
training structures on the fly.

Device/host split: the per-step hot path is one predict call on the card
(descriptors → covariance → energy/forces/virial/β) and one host pull; all
sampling decisions, threshold logic, tape/model IO and the m×m solve run
on the host.  β updates inside the inducing-sampling loop are computed on
the host from the already-fetched covariance rows, so the loop adds no
extra device round trips.

The engine's whole kernel space is served (kernel expressions, alchemical
mixing, pair terms), and ``kernel_hpo=k`` optimizes the kernel
expression's hyperparameters every k-th model update
(:mod:`..regression.hpo`).  A metadynamics bias (``calc.meta``, one of
:mod:`.meta`) adds its energy and forces after each prediction.  With
``mesh=`` (:func:`..parallel.mesh.make_mesh`) the engine predicts and
builds the training covariance sharded over the mesh.
"""

from __future__ import annotations

import os
import time
from collections import Counter

import numpy as np

from ..descriptor.radial import DefaultRadii
from ..descriptor.soap import SoapParams
from ..engine import Engine, device_fetch, voigt6
from ..io.tape import SgprTape
from ..kernelalgebra import KernelExpr
from ..neighbors import VerletNeighborCache, neighbor_table, round_up
from ..regression.sgpr import DataRecord, InducingEnv, SgprModel
from ..system import SinglePointCalculator

inf = float("inf")
kcal_mol = 0.043


class Switch:
    """Piecewise-constant thresholds keyed on max force (active.py:83-101)."""

    def __init__(self, value):
        self._value = value
        value = value if isinstance(value, (list, tuple)) else [value]
        self.switches = (-inf, *value[1::2], inf)
        self.values = value[0::2]
        for k in range(len(self.switches) - 1):
            if self.switches[k] > self.switches[k + 1]:
                raise RuntimeError("Switch is not ordered!")

    def __repr__(self):
        return f"{self._value}"

    def __call__(self, x):
        k = 0
        for k in range(len(self.switches) - 1):
            if self.switches[k] < x < self.switches[k + 1]:
                break
        return self.values[k]


def default_kernel_engine(lmax=3, nmax=3, exponent=4, cutoff=6.0, species=None,
                          radii=None, device="cuda", dtype=None):
    """Default SOAP kernel config (reference active.py:28-38)."""
    return Engine(
        params=SoapParams(lmax=lmax, nmax=nmax, rc=cutoff),
        exponent=exponent,
        radii=radii if radii is not None else DefaultRadii(),
        species=species,
        device=device,
        dtype=dtype,
    )


class ActiveCalculator:
    """On-the-fly SGPR learner with the reference's sampling policy; with
    ``calculator=None`` it serves a trained model (``covariance``: a model
    folder, an :class:`SgprModel` or an :class:`Engine`).

    ``device``/``dtype`` place a new model's engine (a loaded folder's
    too); ``skin`` is the Verlet skin of the neighbor cache and
    ``kpad_min`` a floor for the sticky neighbor-slot bucket."""

    # the covariance block is fetched on every step, learning or not
    # (MultiTaskCalculator's per-task energies read it)
    _always_fetch_cov = False

    def __init__(
        self,
        covariance="pckl",
        calculator=None,
        logfile="active.log",
        pckl="model.pckl",
        tape="model.sgpr",
        test=None,
        stdout=False,
        ediff=2 * kcal_mol,
        ediff_lb=None,
        ediff_ub=None,
        ediff_tot=4 * kcal_mol,
        fdiff=3 * kcal_mol,
        noise_f=kcal_mol,
        ioptim=1,
        max_data=inf,
        max_inducing=inf,
        kernel_kw=None,
        veto=None,
        eps_dr=0.1,
        ignore=None,
        report_timings=False,
        step0_forced_fp=False,
        mesh=None,
        skin=0.3,
        kpad_min=0,
        nbeads=1,
        seed=None,
        kernel_hpo=None,
        device="cuda",
        dtype=None,
    ):
        if calculator is not None and not callable(
                getattr(calculator, "calculate", None)):
            raise TypeError(f"oracle {calculator!r} has no calculate()")
        self._calc = calculator
        self.pckl = pckl
        self._get_model(covariance, kernel_kw or {}, device, dtype)
        self.mesh = mesh
        if mesh is not None:
            # sharded predict and training covariance (parallel/mesh.py)
            self.engine.mesh = mesh
        self.ediff = ediff
        self.ediff_lb = ediff_lb if ediff_lb is not None else ediff
        self.ediff_ub = ediff_ub if ediff_ub is not None else ediff
        self.ediff_tot = ediff_tot
        self.fdiff = fdiff
        self.noise_f = noise_f
        self.ioptim = ioptim
        self._ioptim = 0
        self.max_data = max_data
        self.max_inducing = max_inducing
        self.logfile = logfile
        self.stdout = stdout
        self.step = 0
        self.maximum_force = inf
        self.tape = SgprTape(tape) if tape else None
        self.test = test
        self._last_test = 0
        self._ktest = 0
        self.meta = None  # a metadynamics bias (calculator/meta.py)
        self.deltas = None
        self.updated = False
        self._update_args = {}
        self._veto = veto or {}
        self.eps_dr = eps_dr
        self.ignore = set(ignore or [])
        self.report_timings = report_timings
        self.step0_forced_fp = step0_forced_fp
        self.tune_for_md = True
        self._saved_for_tape = None
        self._npad = 0
        self._cov = None
        self._beta_dev = None
        self._desc = None
        # neighbor-slot bucket floor, on the 16-slot bucket grid
        self._kpad = round_up(int(kpad_min), 16) if kpad_min else 0
        self._nlcache = VerletNeighborCache(self.engine.params.rc, skin=skin)
        # kernel-hyperparameter optimization cadence: every k-th model
        # update, maximize the marginal likelihood over the KernelExpr's
        # trainable parameters and rebuild the covariance blocks; None
        # disables
        self.kernel_hpo = kernel_hpo
        self._hpo_count = 0
        # wall-clock accounting per phase: staging/predict/active/post
        # from calculate()'s segment clocks; upd_inducing/upd_data/
        # upd_refit/oracle from update().  The OTF phase of chip_smoke.py
        # reads these to report where the learning wall goes.
        self.phase_wall = Counter()
        self.event_counts = Counter()
        self.nbeads = int(nbeads)
        # deterministic default: seed=None means a fixed seed (the rng
        # drives sample_rand_lces' rattles); seed='random' for entropy
        self.rng = np.random.default_rng(
            None if seed == "random" else (0 if seed is None else seed)
        )
        self.cfg = None
        self._cfg_key = None
        self.results = {}
        self.covlog = ""
        self.log("active calculator says Hello!", mode="w")
        self.log(f"kernel: params={self.engine.params} zeta={self.engine.exponent}")
        self.log(
            f"settings: ediff: {self._ediff}  ediff_tot: {self.ediff_tot}"
            f"  fdiff: {self._fdiff} "
        )
        self.log("model size: {} {}".format(*self.size))

    # ----------------------------------------------------------- properties
    @property
    def active(self):
        return self._calc is not None

    def _untrained(self):
        """No servable model (a committee counts its frozen experts)."""
        return self.size[1] == 0

    @property
    def engine(self) -> Engine:
        return self.model.engine

    @property
    def size(self):
        return self.model.size

    # Switch-able thresholds (reference active.py:378-421)
    @property
    def fdiff(self):
        return self._fdiff(self.maximum_force)

    @fdiff.setter
    def fdiff(self, value):
        self._fdiff = value if isinstance(value, Switch) else Switch(value)

    @property
    def ediff(self):
        return self._ediff(self.maximum_force)

    @ediff.setter
    def ediff(self, value):
        self._ediff = value if isinstance(value, Switch) else Switch(value)

    @property
    def ediff_lb(self):
        return self._ediff_lb(self.maximum_force)

    @ediff_lb.setter
    def ediff_lb(self, value):
        self._ediff_lb = value if isinstance(value, Switch) else Switch(value)

    @property
    def ediff_ub(self):
        return self._ediff_ub(self.maximum_force)

    @ediff_ub.setter
    def ediff_ub(self, value):
        self._ediff_ub = value if isinstance(value, Switch) else Switch(value)

    # -------------------------------------------------------- model loading
    def _get_model(self, covariance, kernel_kw, device, dtype):
        from ..io.model_io import load_model

        if covariance == "pckl":
            covariance = self.pckl if self.pckl and os.path.isdir(self.pckl) else None
        if covariance is None:
            self.model = SgprModel(
                default_kernel_engine(**kernel_kw, device=device, dtype=dtype))
        elif isinstance(covariance, str):
            self.model = load_model(covariance, device=device, dtype=dtype)
        elif isinstance(covariance, SgprModel):
            self.model = covariance
        elif isinstance(covariance, Engine):
            self.model = SgprModel(covariance)
        else:
            raise TypeError(f"covariance: {covariance!r}")

    # ------------------------------------------------------------- calculate
    def calculate(self, system) -> dict:
        timings = [time.time()]
        if self._untrained() and not self.active:
            raise RuntimeError("you forgot to assign an oracle calculator!")
        if self.engine.ensure_species(system.numbers):
            self.model.restage()

        self.system = system
        self._make_cfg(system)
        timings.append(time.time())  # nl + staging

        self.maximum_force = inf
        if self.step == 0 and self.active and self.model.ndata == 0:
            self.initiate_model()
            self._update_args = dict(data=False)

        self._predict()
        timings.append(time.time())  # kernel + results

        self.deltas = None
        self.covlog = ""
        # PIMD: only the first bead is sampled (reference active.py:477-491)
        first_bead = self.nbeads == 1 or (self.step + 1) % self.nbeads == 1
        if self.active and not self.veto() and first_bead:
            pre = dict(self.results)
            m, n = self.update(**self._update_args)
            if m > 0 or n > 0:
                self._predict()
                if self.step > 0:
                    self.deltas = {
                        q: self.results[q] - pre[q]
                        for q in ("energy", "forces", "stress")
                    }
        elif self.size[1] > 0:
            covloss_max = float(self._host_beta().max())
            self.covlog = f"{covloss_max}"
            if covloss_max > self.ediff:
                self._save_uncertain()
        timings.append(time.time())  # active

        self.post_calculate(timings)
        return self.results

    def post_calculate(self, timings):
        if self.active and self.test and self.step - self._last_test > self.test:
            self._test()
        meta = ""
        if self.meta is not None:
            me = self.meta(self)
            if me is not None:
                self.results["energy"] = self.results["energy"] + me["energy"]
                if "forces" in me:
                    self.results["forces"] = self.results["forces"] + me["forces"]
                meta = f"meta: {me['energy']}"
        self.log(
            "{} {} {} {}".format(
                self.results["energy"], self.system.get_temperature(),
                self.covlog, meta,
            )
        )
        self.step += 1
        self.results["free_energy"] = self.results["energy"]
        timings.append(time.time())
        for key, dt in zip(
            ("staging", "predict", "active", "post"), np.diff(timings)
        ):
            self.phase_wall[key] += float(dt)
        self.event_counts["calculate"] += 1
        if self.report_timings:
            d = np.diff(timings)
            self.log(
                ("timings:" + len(d) * " {:0.2g}").format(*d)
                + f" total: {sum(d):0.2g}"
            )

    # ----------------------------------------------------------- prediction
    def _make_cfg(self, system):
        table, rebuilt = self._nlcache.update(
            system.positions, system.cell, system.pbc
        )
        self._nl = table
        key = (len(system), tuple(self.engine.species))
        if rebuilt or self.cfg is None or key != self._cfg_key:
            npad0, kpad0 = self._npad, self._kpad
            self._npad = max(self._npad, round_up(len(system), 16))
            # sticky neighbor bucket with +20% headroom, so thermal
            # fluctuations of kmax at rc + skin do not change the shapes
            self._kpad = max(self._kpad, round_up(int(table.kmax * 1.2) + 4, 16))
            if npad0 and self._npad > npad0:
                self.event_counts["npad_growth"] += 1
            if kpad0 and self._kpad > kpad0:
                self.event_counts["kpad_growth"] += 1
            self.cfg = self.engine.make_config(
                system,
                npad=self._npad,
                kpad=self._kpad,
                table=table.pad_to(self._kpad),
            )
            self._cfg_key = key
        else:
            self.cfg = self.engine.update_positions(self.cfg, system)

    def _padded_numbers(self):
        numbers = np.zeros(self.cfg.npad, dtype=np.int32)
        numbers[: len(self.system)] = self.system.numbers
        return numbers

    def _predict(self):
        n = len(self.system)
        m = self.model.m
        ma = self.model.full_model_arrays()
        # vs is inf for species without a vscale: the device beta is then
        # inf too, above every threshold, as the host formula has it
        vs = self.model.vscale_for(self._padded_numbers())
        e, f, w, cov, beta = self.engine.predict(self.cfg, ma, vs)
        # one device->host transfer per step: learning steps take the
        # (n, m) covariance rows (the sampling loop's β), serving steps
        # only the per-atom β, unless a metadynamics bias (SoapMeta reads
        # the rows) or the multi-task energies need them.  The β shortcut
        # is taken only for the plain normalized dot kernel, as in the JAX
        # package: the host k(x, x) (_host_alpha) and the device's differ
        # for the mixed normed kernel, and mixing the two would shift the
        # thresholds between learning and serving steps
        want_cov = (self.active or self._always_fetch_cov
                    or self.meta is not None or not self.engine.plain_kernel)
        tail = cov[:n, :m] if want_cov else beta[:n]
        e, f, w, tail = device_fetch(e, f, w, tail)
        energy = float(e) + self.model.mean_energy(self.system.numbers)
        forces = f[:n].astype(np.float64)
        try:
            stress = voigt6(w) / self.system.volume
        except ValueError:
            stress = np.zeros(6)
        self.results = {"energy": energy, "forces": forces, "stress": stress}
        self.maximum_force = float(np.abs(forces).max()) if n else inf
        if want_cov:
            self._cov = tail.astype(np.float64)
            self._beta_dev = None
        else:
            self._cov = None
            self._beta_dev = tail.astype(np.float64)
        self._desc = None  # fetched lazily in the sampling loop
        return self.results

    def _get_desc(self):
        if self._desc is None:
            n = len(self.system)
            arrays = self.engine.descriptors(self.cfg)
            if self.engine.pair_terms:
                arrays += (self.engine.pair_self(self.cfg),)
            p, lone, *pair = device_fetch(*arrays)
            self._desc = p[:n].astype(np.float64)
            self._lone = lone[:n]
            self._pair_alpha = pair[0][:n].astype(np.float64) if pair else None
        return self._desc

    def _host_alpha(self):
        """Per-atom kernel diagonal k(x,x) for covloss normalization: 1
        for the default normalized dot kernel; the alchemical mixing and
        kernel expressions change it, and the pair terms add their own
        k(P, P), as in the device β.  (The JAX package's host loop leaves
        the pair share out; c then exceeds 1 on the pair-selected atoms,
        their β is 0 and they are never sampled.)"""
        eng = self.engine
        kind = eng.kernel_kind
        if not (isinstance(kind, KernelExpr) or eng.chemical or eng.pair_terms):
            return 1.0
        p = self._get_desc()
        if isinstance(kind, KernelExpr):
            a = np.asarray(kind.value((p * p).sum(axis=1), xp=np))
            a = a + float(kind.white_diag(xp=np))
            a = np.where(self._lone, a + 1.0, a)
        elif eng.chemical:
            a = (p * p).sum(axis=1)
            if kind == "dot":
                a = a**eng.exponent
            a = np.where(self._lone, a + 1.0, a)
        else:
            a = np.ones(len(p))
        if eng.pair_terms:
            a = a + self._pair_alpha
        return np.maximum(a, 1e-12)

    def _host_beta(self):
        """β from host-side cov/choli (active.py:781-804), updatable inside
        the sampling loop without device round trips.  Serving steps skip
        the covariance fetch and return the device β."""
        m = self.model.m
        if m == 0 or len(self.model.mu) != m:
            return np.full(len(self.system), inf)
        if self._cov is None:
            if self._beta_dev is not None:
                return self._beta_dev
            return np.full(len(self.system), inf)
        return self._beta_from_c(self._host_c())

    def _host_c(self):
        """Per-atom normalized squared projection c (the O(N m^2) part
        of the covloss; update_inducing maintains it incrementally
        across bordered commits)."""
        b = self.model.choli @ self._cov.T
        return (b * b).sum(axis=0) / self._host_alpha()

    def _beta_from_c(self, c):
        beta = np.sqrt(np.clip(1.0 - c, 0.0, None))
        vs = self.model.vscale_for(self.system.numbers)
        return beta * np.sqrt(vs)

    def _extend_cov(self, env):
        """Append the kernel column of a new inducing env to host cov
        (the base-kernel kind, the chemical central factor and the pair
        terms)."""
        p = self._get_desc()
        model = self.model
        numbers = self.system.numbers
        col = model._base_kernel(p @ env.desc)
        central = np.array([model._central(int(z), env.number)
                            for z in numbers])
        col = col * central
        col = col + ((self._lone & env.lone) & (numbers == env.number))
        if self.engine.pair_terms:
            from ..pairkernels import pair_cols_config_np

            col = col + pair_cols_config_np(
                self.system.positions, self.system.cell,
                np.asarray(numbers), self._nl, self.engine.params.rc, env,
                self.engine.pair_terms,
            )
        self._cov = np.concatenate([self._cov, col[:, None]], axis=1)

    # --------------------------------------------------------------- the LCEs
    def extract_env(self, i, system=None, nl=None) -> InducingEnv:
        """Detach the LCE of atom i (reference atoms.py local()+detach)."""
        system = system or self.system
        if nl is None:
            nl = self._nl
        mask = nl.mask[i]
        j = nl.idx[i][mask]
        r = (
            system.positions[j]
            - system.positions[i]
            + nl.off[i][mask] @ system.cell
        )
        # skin-buffered tables may include inert pairs beyond rc; drop them
        rc = self.engine.params.rc
        within = (r * r).sum(axis=1) <= rc * rc
        return InducingEnv.from_arrays(
            system.numbers[i], r[within], system.numbers[j][within]
        )

    # ------------------------------------------------------- model seeding
    def initiate_model(self):
        rec = self.snapshot(fake=False)
        unique = self.get_unique_lces()
        envs = [self.extract_env(i) for i in unique]
        self.model.stage_envs(envs)  # one dispatch for all seed LCEs
        for env in envs:
            self.model.add_inducing(env, remake=False)
        self.model.add_data(rec, remake=False)
        self.model.make_munu()
        if self.tape:
            if self._saved_for_tape is not None:
                self.tape.write(self._saved_for_tape)
                self._saved_for_tape = None
            for x in self.model.X:
                self.tape.write(x)
        details = [(int(j), int(self.system.numbers[j])) for j in unique]
        self.log("seed size: {} {} details: {}".format(*self.size, details))
        if self.tune_for_md:
            self.sample_rand_lces(indices=unique, repeat=1)
        self.optimize()
        self.save_model()

    def get_unique_lces(self, thresh=0.95):
        """Greedy kernel-similarity filter (active.py:632-653): one boolean
        "still novel" mask updated per accepted LCE."""
        (k,) = device_fetch(self.engine.gram_self(self.cfg))
        n = len(self.system)
        unique = []
        novel = np.ones(n, dtype=bool)
        for i in range(n):
            if novel[i]:
                unique.append(i)
                novel &= k[:n, i] < thresh
        return unique

    def sample_rand_lces(self, indices=None, repeat=1):
        """Rattled-copy LCE sampling for MD robustness (active.py:655-682)."""
        added = 0
        rng = self.rng
        for _ in range(repeat):
            tmp = self.system.copy()
            tmp.positions = tmp.positions + rng.uniform(
                -0.05, 0.05, tmp.positions.shape
            )
            nl = neighbor_table(tmp.positions, tmp.cell, tmp.pbc, self.engine.params.rc)
            idx = (
                indices
                if indices is not None
                else rng.permutation(len(tmp)).tolist()
            )
            envs = [self.extract_env(k, system=tmp, nl=nl) for k in idx]
            # one staging + column pull for all of them
            self.model.precompute_column_blocks(envs)
            for env in envs:
                added += abs(self.update_lce(env))
        self.log(f"added {added} randomly displaced LCEs")

    # ------------------------------------------------------------- sampling
    def update_lce(self, env: InducingEnv, beta=None):
        """Threshold-banded inducing addition (active.py:806-840)."""
        model = self.model
        if env.desc is None:
            model.stage_env(env)
        col = None
        if beta is None:
            col = model.kern_X_env(env)
            # choli can lag X before the first data record exists (an
            # LCE-first tape): an unsolved model explains no variance
            solved = model.m and model.choli.shape == (model.m, model.m)
            b = model.choli @ col if solved else np.zeros(0)
            alpha = model.kern_env_env(env, env)
            c = float(b @ b) / max(alpha, 1e-12)
            vscale = model.vscale.get(env.number, inf)
            beta = np.sqrt(max((1.0 - c) * vscale, 0.0))
        added = 0
        m = model.indu_counts.get(env.number, 0)
        if beta >= self.ediff_ub:
            model.fast_add_inducing(env, col=col)
            added = -1 if m < 2 else 1
        elif beta < self.ediff_lb:
            if m < 2:
                # robust variant of the beta > eps guard (active.py:824-826):
                # in float32 the covloss of near-duplicate environments
                # rounds to exactly 0, which would deadlock seeding, so test
                # duplication on the kernel column directly, normalized by
                # the diagonals k(x,x), k(y,y)
                if col is None:
                    col = model.kern_X_env(env)
                if len(col):
                    a_env = model.kern_env_env(env, env)
                    diag = model.kern_X_diag()  # cached until X changes
                    sim = col / np.sqrt(np.maximum(diag * a_env, 1e-24))
                    kmax = float(sim.max())
                else:
                    kmax = 0.0
                if kmax < 1.0 - 1e-6:
                    model.fast_add_inducing(env, col=col)
                    added = -1
        else:
            ediff = self.ediff if m > 1 else np.finfo(np.float64).eps
            added, _delta = model.add_1inducing(env, ediff)
        if added != 0:
            if model.ridge > 0.0:
                model.pop_1inducing()
                added = 0
            else:
                if self.tape:
                    self.tape.write(env)
                if self.ioptim == 0:
                    self.optimize()
        return added

    def update_inducing(self):
        """Greedy argmax-β loop (active.py:842-885)."""
        added_beta = 0
        added_diff = 0
        added_indices = []
        added_covloss = None
        self.blind = False
        n = len(self.system)
        model = self.model

        # incremental covloss across the greedy loop: a bordered fast
        # commit extends choli by ONE row, so c gains one exact term
        # (O(N m)) instead of the full O(N m^2) recompute
        def _c_ok():
            # _host_c is only meaningful on a SOLVED model whose host cov
            # matches: fast_add_inducing below fast_trial_min_m grows X
            # without extending choli, so m/choli/cov can disagree mid-loop
            return (
                self._cov is not None
                and model.m > 0
                and len(model.mu) == model.m
                and model.choli.shape[0] == model.m
                and self._cov.shape[1] == model.m
            )

        c_arr = self._host_c() if _c_ok() else None
        beta = self._host_beta() if c_arr is None else self._beta_from_c(c_arr)
        env_cache = {}  # k -> staged env (top-of-order lookahead batches)
        while len(added_indices) < n:
            if c_arr is not None:
                beta = self._beta_from_c(c_arr)
            else:
                beta = self._host_beta()
            order = np.argsort(beta)[::-1]
            k = None
            for kk in order.tolist():
                if kk not in added_indices and kk not in self.ignore:
                    k = kk
                    break
            if k is None:
                break
            if np.isclose(beta[k], 1.0):
                self.blind = True
            if k not in env_cache:
                # stage the next few argmax candidates and their data
                # columns with one host pull
                tried = set(added_indices) | set(self.ignore)
                todo = []
                for kk in order.tolist():
                    if kk not in tried and kk not in env_cache:
                        todo.append(kk)
                        if len(todo) == 8:
                            break
                for kk in todo:
                    env_cache[kk] = self.extract_env(kk)
                self.model.precompute_column_blocks(
                    [env_cache[kk] for kk in todo]
                )
            env = env_cache.pop(k)
            m0 = model.m
            added = self.update_lce(env, beta=beta[k])
            if added == 0:
                break
            if added == -1:
                self.blind = True
                added_beta += 1
            else:
                added_diff += 1
            self._extend_cov(self.model.X[-1])
            if (c_arr is not None and model.m == m0 + 1
                    and model._bordered_sv == model.state_version
                    and self._cov is not None
                    and self._cov.shape[1] == model.m
                    and model.choli.shape[0] == model.m):
                # exact rank-1 covloss update from the bordered commit
                bn = self._cov @ model.choli[-1]
                c_arr = c_arr + bn * bn / self._host_alpha()
            else:
                c_arr = self._host_c() if _c_ok() else None
            added_indices.append(k)
            added_covloss = beta[k]
        added = added_beta + added_diff
        if added > 0:
            self.log(
                "added indu: {} ({},{}) -> size: {} {} details: {:.2g}".format(
                    added, added_beta, added_diff, *self.size, added_covloss
                )
            )
            if self.blind:
                self.log("model may be blind -> go robust")
        self.covlog = f"{float(beta.max()) if len(beta) else 0.0}"
        return added

    # ----------------------------------------------------------- structures
    def _exact(self, system):
        """One oracle single-point (reference _exact, active.py:710-738)."""
        t0 = time.time()
        self.event_counts["fp_calls"] += 1
        tmp = system.copy()
        tmp.calc = self._calc
        energy = tmp.get_potential_energy()
        forces = tmp.get_forces()
        try:
            stress = tmp.get_stress()
        except Exception:
            stress = np.zeros(6)
        if self.tape:
            tmp.calc = SinglePointCalculator(
                tmp, energy=energy, forces=forces, stress=stress
            )
            self._saved_for_tape = tmp
        self.log(f"exact energy: {energy}")
        if self.model.ndata > 0 and "energy" in self.results:
            dE = self.results["energy"] - energy
            df = np.abs(self.results["forces"] - forces)
            self.log(
                "errors (pre):  del-E: {:.2g}  max|del-F|: {:.2g}  mean|del-F|: {:.2g}".format(
                    dE, df.max(), df.mean()
                )
            )
        self._last_test = self.step
        self.phase_wall["oracle"] += time.time() - t0
        return energy, forces, stress

    def snapshot(self, fake=False) -> DataRecord:
        copy = self.system.copy()
        if fake:
            energy = self.results["energy"]
            forces = self.results["forces"]
            stress = self.results["stress"]
        else:
            energy, forces, stress = self._exact(copy)
        return DataRecord(
            system=copy,
            e=float(energy),
            f=np.asarray(forces).copy(),
            s=np.asarray(stress).copy(),
            natoms=len(copy),
        )

    def head(self):
        """Replace the last (fake) data targets with exact ones
        (active.py:753-761)."""
        rec = self.model.data[-1]
        energy, forces, stress = self._exact(rec.system)
        if not (np.all(np.isfinite(energy)) and np.isfinite(forces).all()):
            self.log("rejected exact data with non-finite targets")
            self.model.pop_1data()
            return
        rec.e = float(energy)
        rec.f = np.asarray(forces).copy()
        rec.s = np.asarray(stress).copy()
        self.model.touch_targets()  # in-place retarget: QR cache stale
        self.model.make_munu()

    def _fast_ef(self):
        """Energy/forces under the current mu (one device pass, one pull)."""
        ma = self.model.full_model_arrays()
        vs = self.model.vscale_for(self._padded_numbers())
        e, f, *_ = self.engine.predict(self.cfg, ma, vs)
        e, f = device_fetch(e, f)
        return float(e), f[: len(self.system)].astype(np.float64)

    def add_1atoms_fast(self, rec):
        """Accept/reject a structure by Δprediction (gppotential.py:888-940).

        The Δ is computed on the host from the record's own kernel rows:
        rec is a snapshot of the current system, so the Ke/Kf rows that
        add_data appends are the energy/force kernels of the current
        configuration, and e = ke_row @ mu, f = kf_rows @ mu is the same
        math as two device predict passes.  A rejected trial restores the
        pre-add solve from a snapshot instead of re-solving."""
        model = self.model
        if model.ndata == 0:
            model.add_data(rec)
            return 1, inf, inf
        fdiff = self.fdiff
        use_forces = fdiff < inf
        mu1 = np.asarray(model.mu, dtype=np.float64)
        host_ok = (
            model.m > 0
            and len(mu1) == model.m
            and model.choli.shape == (model.m, model.m)
        )
        snap = model.solve_snapshot() if host_ok else None
        if not host_ok:
            e1, f1 = self._fast_ef()
        model.add_data(rec)
        if host_ok:
            nf = 3 * rec.natoms
            ke_row = np.asarray(model.Ke[-1], dtype=np.float64)
            kf_rows = np.asarray(model.Kf[-nf:], dtype=np.float64)
            mu2 = np.asarray(model.mu, dtype=np.float64)
            e1 = float(ke_row @ mu1)
            e2 = float(ke_row @ mu2)
            d = kf_rows @ (mu2 - mu1) if use_forces else None
        else:
            e2, f2 = self._fast_ef()
            d = (f2 - f1).reshape(-1) if use_forces else None
        de = abs(e1 - e2)
        df = 0.0
        if not use_forces:
            reject = de < self.ediff_tot
        else:
            df = np.abs(d).mean()
            df_max = np.abs(d).max()
            # Normal-logprob test: mean log N(d;0,fdiff) > log N(fdiff;0,fdiff)
            # ⇔ mean(d²) < fdiff²  (gppotential.py:930-932)
            reject = (d * d).mean() < fdiff**2 and df_max < 3 * fdiff
        blind = abs(e1) < 1e-8 and abs(e2) < 1e-8
        if reject and not blind:
            if snap is not None:
                model.pop_1data(remake=False)
                model.restore_solve(snap)
            else:
                model.pop_1data()
            return 0, de, df
        return 1, de, df

    def update_data(self, try_fake=True):
        """Sample a training structure (active.py:887-929)."""
        model = self.model
        # bypass if barely moved since the last sample
        if self.tune_for_md and model.ndata > 2:
            last = model.data[-1]
            if last.natoms == len(self.system) and (
                last.system.numbers == self.system.numbers
            ).all():
                if (
                    np.abs(last.system.positions - self.system.positions)
                    < self.eps_dr
                ).all():
                    return 0
        n0 = model.ndata
        rec = self.snapshot(fake=try_fake)
        if not (np.isfinite(rec.e).all() and np.isfinite(rec.f).all()):
            # a diverged oracle result must never poison the regression
            self.log("rejected data with non-finite targets")
            return 0
        a, de, df = self.add_1atoms_fast(rec)
        added = model.ndata - n0
        self.log(f"DF: {df}  accept: {added}")
        if added > 0:
            if try_fake:
                self.head()
            if self._saved_for_tape is not None and self.tape:
                self.tape.write(self._saved_for_tape)
                self._saved_for_tape = None
            self.log("added data: {} -> size: {} {}".format(added, *self.size))
            if self.ioptim in (0, 2):
                self.optimize()
            elif self.ioptim > 2:
                self._ioptim += 1
                if self._ioptim % (self.ioptim - 1) == 0:
                    self.optimize()
                    self._ioptim = 0
        return added

    # ------------------------------------------------------------ update
    def veto(self):
        if self.size[0] < 2:
            return False
        if "forces" in self._veto and "forces" in self.results:
            if np.abs(self.results["forces"]).max() >= self._veto["forces"]:
                self.log("an update is vetoed!")
                return True
        return False

    def optimize(self):
        self.model.optimize_model_parameters(noise_f=self.noise_f)

    def optimize_kernel(self):
        """Marginal-likelihood optimization of the kernel expression's
        trainable hyperparameters + full covariance rebuild
        (regression/hpo.py; reference gppotential.py:352-371)."""
        from ..regression.hpo import optimize_kernel_params

        if not isinstance(self.engine.kernel_kind, KernelExpr):
            return False
        moved = optimize_kernel_params(self.model, noise_e=self.noise_f)
        if moved:
            self.model.rebuild_kernel_matrices(remake=True)
            self._cov = None  # host covariance rows are stale too
            self._beta_dev = None
            self.log(f"kernel HPO: {self.engine.kernel_kind.state}")
        return moved

    def update(self, inducing=True, data=True):
        """Orchestrate sampling + downsize + HPO (active.py:940-983)."""
        self.updated = False
        self.blind = False
        t0 = time.time()
        m = self.update_inducing() if inducing else 0
        self.phase_wall["upd_inducing"] += time.time() - t0
        try_real = self.blind or isinstance(self._calc, SinglePointCalculator)
        update_data = (m > 0 and data) or not inducing
        if update_data and not inducing:
            update_data = self._host_beta().max() > self.ediff
        t0 = time.time()
        n = self.update_data(try_fake=not try_real) if update_data else 0
        self.phase_wall["upd_data"] += time.time() - t0

        if self.step == 0 and self.step0_forced_fp and data and n == 0:
            self.log("forced data addition")
            self.model.add_data(self.snapshot(fake=False))
            self.log("added data: {} -> size: {} {}".format(1, *self.size))
            n = 1

        if m > 0 or n > 0:
            t0 = time.time()
            self.event_counts["added_inducing"] += m
            self.event_counts["added_data"] += n
            self.event_counts["updates"] += 1
            ch1, ch2 = self.model.downsize(self.max_data, self.max_inducing)
            if ch1 or ch2:
                self.log("downsized -> size: {} {}".format(*self.size))
            if isinstance(ch2, list):
                self._cov = self._cov[:, ch2]
            if self.ioptim == 1:
                self.optimize()
            st = self.model.stats
            self.log(
                "fit error (mean,mae): E: {:.2g} {:.2g}   F: {:.2g} {:.2g}   R2: {:.4g}".format(
                    st["e_mean"], st["e_mae"], st["f_mean"], st["f_mae"], st["r2"]
                )
            )
            self.log(f"noise: {self.model.scaled_noise}")
            self.log(f"mean: {self.model.mean_weights}")
            if self.kernel_hpo:
                self._hpo_count += 1
                if self._hpo_count % self.kernel_hpo == 0:
                    self.event_counts["kernel_hpo"] += 1
                    if self.optimize_kernel():
                        self.event_counts["kernel_hpo_moved"] += 1
            self.save_model()
            self.updated = True
            self.phase_wall["upd_refit"] += time.time() - t0
        self._update_args = {}
        return m, n

    # -------------------------------------------------------------- testing
    def _test(self):
        from ..io.xyz import write_xyz

        tmp = self.system.copy()
        tmp.calc = self._calc
        energy = tmp.get_potential_energy()
        forces = tmp.get_forces()
        try:
            stress = tmp.get_stress()
        except Exception:
            stress = np.zeros(6)
        self._ktest += 1
        mode = "a" if self._ktest > 1 else "w"
        tmp.calc = SinglePointCalculator(
            tmp, energy=energy, forces=forces, stress=stress
        )
        write_xyz("active_FP.extxyz", tmp, mode=mode)
        ml = self.system.copy()
        ml.calc = SinglePointCalculator(ml, **self.results)
        write_xyz("active_ML.extxyz", ml, mode=mode)
        dE = self.results["energy"] - energy
        df = np.abs(self.results["forces"] - forces)
        self.log(
            "errors (test):  del-E: {:.2g}  max|del-F|: {:.2g}  mean|del-F|: {:.2g}".format(
                dE, df.max(), df.mean()
            )
        )
        self._last_test = self.step
        return energy, forces

    def _save_uncertain(self):
        from ..io.xyz import write_xyz

        tmp = self.system.copy()
        tmp.calc = None
        write_xyz("active_uncertain.extxyz", tmp, mode="a")

    # ------------------------------------------------------------- offline
    def include_data(self, data, fmax=inf):
        """Train on precomputed structures (active.py:989-1004); structures
        with |F| > fmax are skipped (include_params filter)."""
        from ..io.xyz import read_xyz

        if isinstance(data, str):
            data = read_xyz(data)
        _calc = self._calc
        for s in data:
            if fmax < inf and np.abs(s.get_forces()).max() > fmax:
                continue
            self._calc = s.calc
            self.calculate(s)
        self._calc = _calc

    def include_tape(self, tape, ndata=None):
        """Train from a .sgpr tape (active.py:1007-1063)."""
        if isinstance(tape, str):
            if self.tape and os.path.abspath(tape) == self.tape.path:
                raise RuntimeError("cannot include own tape!")
            tape = SgprTape(tape)
        self._include_items(tape.read(exclude=self.tape), ndata=ndata)

    def include_folder(self, folder, ndata=None):
        """Train from a reference torch-pickle model folder, the binary
        analog of include_tape: the folder's inducing LCEs and
        FP-labelled training structures are extracted without theforce or
        ase (io/torch_interop.py) and replayed through the same sampling
        loop (reference PosteriorPotentialFromFolder, gppotential.py:
        1342-1368, with retraining: the descriptors differ by design)."""
        from ..io.torch_interop import read_reference_folder

        items, _ = read_reference_folder(folder)
        # only FP-labelled structures can train
        items = [(c, o) for c, o in items
                 if c != "atoms" or getattr(o, "calc", None) is not None]
        self._include_items(items, ndata=ndata)

    def _include_items(self, items, ndata=None):
        _calc = self._calc
        tune = self.tune_for_md
        self.tune_for_md = False
        added_lce = [0, 0]
        cdata = 0
        pend = []

        def _flush():
            # consecutive LCE runs go through ONE batched staging + data
            # column pull; blocks stay valid across the updates because
            # only "atoms" items mutate the data list
            if pend:
                self.model.precompute_column_blocks(pend)
                for o in pend:
                    added = self.update_lce(o)
                    added_lce[0] += abs(added)
                    added_lce[1] += 1
                pend.clear()

        for cls, obj in items:
            if cls == "atoms":
                _flush()
                self._update_args = dict(inducing=False)
                self._calc = obj.calc
                self.calculate(obj)
                cdata += 1
                if ndata and cdata >= ndata:
                    break
            elif cls == "local":
                nums = np.concatenate([[obj.number], obj.numbers])
                if set(int(z) for z in nums) - set(self.engine.species):
                    # flush the pending batch at the OLD species table
                    # before growing it
                    _flush()
                    self.engine.ensure_species(nums)
                    self.model.restage()
                pend.append(obj)
        _flush()
        if added_lce[0] > 0:
            if self.ioptim == 1:
                self.optimize()
            self.save_model()
        self._calc = _calc
        self.tune_for_md = tune
        self._update_args = {}

    def build(self):
        """Rebuild a model from the tape in one shot (active.py:1065-1113)."""
        if self.pckl and os.path.isdir(self.pckl):
            raise RuntimeError(f"{self.pckl} exists; remove it to rebuild")
        data, lce = [], []
        for cls, obj in self.tape.read():
            if cls == "atoms":
                data.append(obj)
            elif cls == "local":
                lce.append(obj)
        for s in data:
            self.engine.ensure_species(s.numbers)
        for x in lce:
            self.engine.ensure_species(np.concatenate([[x.number], x.numbers]))
        for x in lce:
            self.model.add_inducing(x, remake=False)
        for s in data:
            self.model.add_data(DataRecord.from_system(s), remake=False)
        self.model.make_munu()
        self.optimize()
        self.log(
            "built from tape {} {} -> size: {} {}".format(
                len(data), len(lce), *self.size
            )
        )
        self.save_model()

    # -------------------------------------------------------------- output
    def save_model(self):
        if self.pckl:
            from ..io.model_io import save_model

            save_model(self.model, self.pckl)

    def log(self, msg, mode="a"):
        if self.logfile:
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            line = f"{stamp} {self.step} {msg}"
            with open(self.logfile, mode) as f:
                f.write(line + "\n")
            if self.stdout:
                print(line)


class FilterDeltas:
    """Force/stress smoothing across model updates (active.py:47-76).

    Wraps an ActiveCalculator; when the model updates mid-trajectory the
    prediction jump ("deltas") is subtracted and exponentially shrunk so
    the dynamics see a continuous force field.
    """

    def __init__(self, calc: ActiveCalculator, shrink=0.95):
        self.calc = calc
        self.shrink = shrink
        self.f = 0.0
        self.s = 0.0

    def calculate(self, system):
        res = dict(self.calc.calculate(system))
        deltas = self.calc.deltas
        if deltas:
            self.f = self.f + deltas["forces"]
            self.s = self.s + deltas["stress"]
        self.f = self.f * self.shrink
        self.s = self.s * self.shrink
        g = np.clip(self.f, -1.0, 1.0)
        res["forces"] = res["forces"] - g
        res["stress"] = res["stress"] - self.s
        return res
