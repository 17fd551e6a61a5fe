"""Sparse Gaussian process potential: host model state + incremental updates
(port of ``autoforce_tpu/regression/sgpr.py``).

The counterpart of the reference's ``PosteriorPotential``
(theforce/regression/gppotential.py:453-1175).  All covariance *blocks*
(Ke, Kf, Kv, M) live here as float64 numpy; the entries are produced by
the device engine (descriptors and kernel columns on the card).  The solve
runs in :mod:`.solver`; the result (mu, choli) is pushed back to the
device as padded ``ModelArrays``.

Structures ("data") and inducing environments are kept with enough raw
information (positions/neighbors; displacement vectors) to restage
descriptors when the species table grows — kernel *values* are invariant
under table growth (zero blocks), so K matrices stay valid.  Inducing
descriptors are staged in ``Engine.model_dtype`` (float64) by every path
(``restage``, ``stage_env``, ``stage_envs``, ``precompute_column_blocks``),
so an environment gives the same row of M whichever path staged it.

The kernel is the engine's kernel space: the base kernel (``"dot"``,
``"rbf"``, ``"normed"`` or a ``KernelExpr``), the alchemical central
factor, and pair terms, whose staged distances of the inducing set
(``pair_stage``) are cached until the set changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine import Engine, device_fetch, voigt6
from ..kernelalgebra import KernelExpr
from ..system import System
from . import solver


@dataclass
class InducingEnv:
    """A detached local environment (reference Local.detach, atoms.py:149-159)."""

    number: int  # central atomic number
    rvec: np.ndarray  # (k, 3) neighbor displacements
    numbers: np.ndarray  # (k,) neighbor atomic numbers
    desc: np.ndarray = None  # (D,) staged descriptor (current species table)
    lone: bool = False

    @classmethod
    def from_arrays(cls, number, rvec, numbers):
        rvec = np.asarray(rvec, dtype=np.float64).reshape(-1, 3)
        numbers = np.asarray(numbers, dtype=np.int32).reshape(-1)
        return cls(number=int(number), rvec=rvec, numbers=numbers,
                   lone=len(numbers) == 0)


@dataclass
class DataRecord:
    """A training structure with targets and device-ready arrays."""

    system: System
    e: float
    f: np.ndarray  # (n, 3)
    s: np.ndarray  # (6,) Voigt stress
    cfg: object = None  # ConfigArrays
    natoms: int = 0

    @classmethod
    def from_system(cls, system, energy=None, forces=None, stress=None):
        e = float(energy if energy is not None else system.get_potential_energy())
        f = np.asarray(forces if forces is not None else system.get_forces())
        if stress is None:
            try:
                s = np.asarray(system.get_stress())
            except Exception:
                s = np.zeros(6)
        else:
            s = np.asarray(stress)
        return cls(system=system.copy(), e=e, f=f.copy(), s=s.copy(),
                   natoms=len(system))


def _chunks(items, cap):
    """Consecutive chunks of at most ``cap`` items.  The JAX package pads
    each chunk (to a power of two, or to a fixed size) to bound its jit
    shapes; eager torch compiles no shapes, so the padding would be only
    extra work."""
    items = list(items)
    for lo in range(0, len(items), cap):
        yield items[lo : lo + cap]


class SgprModel:
    def __init__(self, engine: Engine, max_data=np.inf, max_inducing=np.inf):
        self.engine = engine
        self.data: list[DataRecord] = []
        self.X: list[InducingEnv] = []
        self.Ke = np.zeros((0, 0))
        self.Kf = np.zeros((0, 0))
        self.Kv = np.zeros((0, 0))
        self.M = np.zeros((0, 0))
        self.mu = np.zeros(0)
        self.choli = np.zeros((0, 0))
        self.ridge = 0.0
        self.noise_state = {"all": solver.logit(0.01)}
        self.scaled_noise = {"all": 0.0}
        self.mean_weights = {}
        self.vscale = {}
        self.indu_counts = {}
        self.stats = None
        # monotonic model-state version: bumped every time the staged
        # device view is invalidated (every mutation of mu/choli/X/data
        # writes ``_model_arrays = None`` — the setter below counts those).
        # Consumers key cached device staging on it; exact, unlike value
        # fingerprints.
        self.state_version = 0
        self._model_arrays = None
        self._pair_stage = None
        self._xdiag = None
        self._xstack = None
        self._fvqr = None
        self._sqr = None
        # precomputed candidate column blocks (precompute_column_blocks):
        # id(env) -> (env, data-fingerprint, blocks); entries are popped
        # on first use and dropped whenever the data list changes
        self._colcache = {}
        # monotonic data-list mutation counter (the colcache fingerprint)
        self._data_version = 0
        # incremental trial-solve gate: below this m the full O(m^3)
        # re-solve is fast anyway AND the frozen-sigma drift of the
        # incremental path is relatively large (the candidate self-kernel
        # shifts sigma's scale by O(b/(m*mean)) — percent-level at seed m,
        # measurably perturbing the chaotic seeding trajectory), so exact
        # semantics win.  Above it, trials go through the bordered
        # stacked-QR factor: O(n m + m^2) per candidate instead of O(m^3).
        self.fast_trial_min_m = 128
        self._mcap = 0
        self.mcap_growth = 0
        # monotonic target-vector version: bumped on EVERY mutation of the
        # regression targets (row append/pop, in-place retarget via
        # touch_targets).  The QR cache keys its validity on this counter —
        # a value-based fingerprint (len/sum/abs-sum) could collide for two
        # different target sets (e.g. a permutation of force rows) and
        # silently reuse a stale factorization.
        self.target_version = 0
        self._kfv_cache = None
        # state_version of the last bordered (one-row choli) commit
        self._bordered_sv = None

    # ------------------------------------------------------------ properties
    @property
    def _model_arrays(self):
        return self.__dict__.get("_ma_cache")

    @_model_arrays.setter
    def _model_arrays(self, value):
        if value is None:
            self.state_version = self.__dict__.get("state_version", 0) + 1
        self.__dict__["_ma_cache"] = value

    @property
    def ndata(self):
        return len(self.data)

    @property
    def m(self):
        return len(self.X)

    @property
    def size(self):
        return (self.ndata, self.m)

    @property
    def species(self):
        return self.engine.species

    def mean_energy(self, numbers):
        """Parametric per-species mean (AutoMean, gppotential.py:200-231)."""
        e = 0.0
        z, c = np.unique(np.asarray(numbers), return_counts=True)
        for zi, ci in zip(z, c):
            e += ci * self.mean_weights.get(int(zi), 0.0)
        return float(e)

    # --------------------------------------------------------------- staging
    def adopt_engine(self, engine):
        """Point this model at another engine (committee experts share the
        live engine's species table and kernel configuration).  Restages
        whenever the species table differs: kernel values do not depend
        on the table, but descriptor blocks and configs do."""
        old = self.engine
        if old is engine:
            return
        same_table = list(old.species) == list(engine.species)
        self.engine = engine
        if self.X and (self.X[0].desc is None
                       or self.X[0].desc.shape[0] != engine.dim
                       or not same_table):
            self.restage()

    def restage(self):
        """Recompute inducing descriptors + data configs for the current
        species table (called when the table grows, and at load)."""
        if self.X:
            self._stage(self.X)
        for rec in self.data:
            rec.cfg = self.engine.make_config(rec.system)
        self._model_arrays = None
        self._pair_stage = None
        self._xdiag = None
        self._xstack = None
        self._fvqr = None
        # staged candidate columns were computed against the OLD species
        # table / descriptors; the data fingerprint cannot see a restage
        self._colcache = {}

    def _stage_dev(self, envs):
        """Descriptors and lone flags of ``envs`` on the device, one
        dispatch, in ``Engine.model_dtype`` (the one staging type)."""
        eng = self.engine
        ev = eng.make_envs([(e.rvec, e.numbers) for e in envs],
                           dtype=eng.model_dtype)
        return eng.env_descriptors(ev)

    def _stage(self, envs):
        """Stage the descriptors of ``envs``, one host pull per 256."""
        for chunk in _chunks(envs, 256):
            p, lone = device_fetch(*self._stage_dev(chunk))
            p = p.astype(np.float64)
            for i, env in enumerate(chunk):
                env.desc = p[i]
                env.lone = bool(lone[i])

    def stage_env(self, env: InducingEnv):
        self._stage([env])
        return env

    def stage_envs(self, envs):
        """Batch-stage descriptors for many raw environments: one device
        dispatch and one pull per 256 environments instead of one per
        environment."""
        self._stage([e for e in envs if e.desc is None])
        return envs

    def _chem_table(self):
        if getattr(self, "_chem_np", None) is None:
            from ..chemical import chem_rbf_table

            self._chem_np = chem_rbf_table()
        return self._chem_np

    def _central(self, za, zb):
        if self.engine.chemical:
            return float(self._chem_table()[za, zb])
        return 1.0 if za == zb else 0.0

    def _base_kernel(self, dot):
        kind = self.engine.kernel_kind
        if isinstance(kind, KernelExpr):
            return np.asarray(kind.value(dot, xp=np))
        if kind == "rbf":
            return np.exp(dot - 1.0)
        if kind == "normed":
            return dot
        return dot**self.engine.exponent

    def kern_env_env(self, a: InducingEnv, b: InducingEnv):
        """Host kernel between two staged environments."""
        c = self._central(a.number, b.number)
        k = c * self._base_kernel(float(np.dot(a.desc, b.desc)))
        if a.lone and b.lone and a.number == b.number:
            k += 1.0
        kind = self.engine.kernel_kind
        if a is b and isinstance(kind, KernelExpr):
            # same-environment White variance (true diagonal only)
            k += float(kind.white_diag(xp=np))
        if self.engine.pair_terms:
            from ..pairkernels import pair_kernel_envs_np

            k += pair_kernel_envs_np(a, b, self.engine.pair_terms)
        return float(k)

    def pair_stage(self):
        """Cached (T, m, kx) pair distances/masks of the inducing set
        (invalidated whenever X changes)."""
        if self._pair_stage is None:
            from ..pairkernels import stage_env_pairs

            terms = self.engine.pair_terms
            for x in self.X:
                self.engine.grow_pair_kx(x)
            kx = self.engine.pair_kx
            T = len(terms)
            d = np.zeros((T, self.m, kx))
            mm = np.zeros((T, self.m, kx), dtype=bool)
            for i, x in enumerate(self.X):
                d[:, i], mm[:, i] = stage_env_pairs(x, terms, kx)
            self._pair_stage = (d, mm)
        return self._pair_stage

    # ------------------------------------------------ incremental QR cache
    # economy QR of the stacked force/virial block K_fv = [Kf; Kv]
    # (Q (n, m), R (m, m), z = Q^T Y_fv), maintained across inducing
    # column appends/pops so mid-sampling-loop solves skip the O(n m^2)
    # refactorization entirely (reference refactors per make_munu,
    # gppotential.py:1261-1263).  Invalidation: target fingerprint (row
    # changes, mutated targets) checked in make_munu.
    _QR_MAX_ELEMS = 5e7  # Q memory guard (~400 MB f64)

    def _fv_targets(self):
        _, forces, virials = self.targets()
        return np.concatenate([forces, virials])

    def _fv_fingerprint(self, y):
        # version counter + length: structurally collision-free as long as
        # every target mutation bumps target_version (add_data/pop_1data do;
        # in-place edits of record targets must call touch_targets)
        return (self.target_version, len(y))

    def touch_targets(self):
        """Declare that target values changed in place (e.g. head() swapping
        fake targets for exact ones): invalidates the incremental QR cache's
        projected target vector."""
        self.target_version += 1

    # The fv-QR cache is R-MODE: it stores only (R, z, y) — never the
    # (n x m) Q factor.  Q was only ever used to project new columns
    # (CGS2) and to delete columns (scipy qr_delete); both have Q-free
    # equivalents (seminormal projection through R, and re-triangularizing
    # R itself), while the update the flagship on-the-fly loop actually
    # needs — appending a new structure's 3N+6 ROWS (add_data) — is
    # impossible to do cheaply WITH a stored Q (every Givens touches all
    # n rows of Q).  R-mode makes add_data O((m+r) m^2) instead of the
    # O(n m^2) full refactorization that invalidation would force on
    # every structure added (and that grows with the training data).
    def _fvqr_build(self, K_fv, y):
        n = K_fv.shape[0]
        if n < self.m or n * max(self.m, 1) > self._QR_MAX_ELEMS:
            self._fvqr = None
            return None
        Q, R = np.linalg.qr(K_fv)  # Q used once for an exact z, then freed
        self._fvqr = dict(
            R=R, z=Q.T @ y, y=y, fp=self._fv_fingerprint(y), chain=0
        )
        return self._fvqr

    def _fvqr_K(self):
        """The stacked (n, m) fv covariance block, canonical row order.

        Cached by ARRAY IDENTITY of (Kf, Kv): every mutation replaces
        those arrays wholesale (concatenate/slice — verified no in-place
        writes anywhere), so `is`-identity of the held references is an
        exact staleness test (unlike the id()-tuple trap of round 4, the
        strong refs keep the ids from being reused); rebuilding the stack
        per call would copy the whole (n, m) block each time."""
        cache = self._kfv_cache
        if (cache is not None and cache[0] is self.Kf
                and cache[1] is self.Kv):
            return cache[2]
        K = np.concatenate([self.Kf, self.Kv], axis=0)
        self._kfv_cache = (self.Kf, self.Kv, K)
        return K

    def _fvqr_chain_step(self, qr, keep_prev=False):
        if not keep_prev:
            # the one-deep row-append undo snapshot is only valid while
            # NO other factor mutation intervened
            qr.pop("prev", None)
        qr["chain"] += 1
        if qr["chain"] > 1024:  # bound seminormal drift; rebuild lazily
            self._fvqr = None

    def _fvqr_project_on(self, K_old, c):
        """Corrected-seminormal projection of column c against (R, K_old)
        with an EXPLICIT residual vector, ITERATED TO CONVERGENCE:
        r = R^-T (K^T c) refined through q = c - K R^-1 r until the
        normal-equation correction ||dr|| is negligible, so rho = ||q||
        carries no subtraction-cancellation loss and zeta = (q/rho)·y
        matches the old CGS2 formulas to working precision.  A fixed
        two-pass version of this drifted at kappa^2 on the near-duplicate
        LCE bases the water-dimer OTF flow produces (round-4 regression:
        served mu 77% off the cache-free solve by m=11) — refinement that
        does NOT measurably converge now reports degeneracy instead of
        laundering an inaccurate factor.  Returns (r, rho, zeta) or None.
        O(n m) per pass — two triangular solves + two GEMVs."""
        qr = self._fvqr
        from scipy.linalg import solve_triangular

        R = qr["R"]
        cn = max(float(np.linalg.norm(c)), 1e-300)
        try:
            r = np.zeros(R.shape[1])
            q = np.asarray(c, dtype=np.float64).copy()
            ok = False
            for _ in range(4):
                dr = solve_triangular(R.T, K_old.T @ q, lower=True)
                if not np.all(np.isfinite(dr)):
                    return None
                r = r + dr
                q = q - K_old @ solve_triangular(R, dr, lower=False)
                # converged when the residual is orthogonal to range(K)
                # at working precision RELATIVE TO the input column
                if float(np.linalg.norm(dr)) <= 1e-13 * max(
                    float(np.linalg.norm(r)), cn
                ):
                    ok = True
                    break
            if not ok:
                # non-contracting refinement = R too ill-conditioned to
                # project through; callers drop the cache (a fresh
                # Householder QR is backward-stable where this is not)
                return None
        except np.linalg.LinAlgError:
            # exactly-singular R (rank-deficient fv block, e.g. duplicate
            # inducing columns right after a species-table growth): the
            # factor cannot project — report degeneracy, callers drop the
            # cache / take the exact path
            return None
        if not (np.all(np.isfinite(r)) and np.all(np.isfinite(q))):
            return None
        rho = float(np.linalg.norm(q))
        if not (np.isfinite(rho) and rho >= 1e-8 * cn):
            # also an overflowed residual (R near singular): the JAX
            # package's code carries the inf into R; here the cache drops
            return None
        zeta = float((q / rho) @ qr["y"])
        return r, rho, zeta

    def _fvqr_append_col(self, c):
        """Column append via the explicit-residual projection; drops the
        cache on degeneracy (new column already in the span).  Called
        AFTER add_inducing extended Kf/Kv, so the current matrices carry
        c as their last column."""
        qr = self._fvqr
        if qr is None:
            return
        m_old = qr["R"].shape[1]
        K = self._fvqr_K()
        if len(c) != K.shape[0] or K.shape[1] != m_old + 1:
            self._fvqr = None
            return
        proj = self._fvqr_project_on(K[:, :m_old], c)
        if proj is None:
            self._fvqr = None
            return
        r, rho, zeta = proj
        Rn = np.zeros((m_old + 1, m_old + 1))
        Rn[:m_old, :m_old] = qr["R"]
        Rn[:m_old, m_old] = r
        Rn[m_old, m_old] = rho
        qr["R"] = Rn
        qr["z"] = np.concatenate([qr["z"], [zeta]])
        self._fvqr_chain_step(qr)

    def _fvqr_append_rows(self, B, y_b, y_new):
        """EXACT row append for a new structure's force/virial rows:
        [R; B] re-triangularized by one small Householder QR — (R, z) are
        row-permutation invariant, so appending at the bottom stands in
        for the canonical [Kf; Kv] interleaving.  O((m + r) m^2) where r
        = 3N+6, vs the O(n_total m^2) full rebuild."""
        qr = self._fvqr
        if qr is None:
            return
        m = qr["R"].shape[1]
        if B.ndim != 2 or B.shape[1] != m or len(y_b) != B.shape[0]:
            self._fvqr = None
            return
        prev = (qr["R"], qr["z"], qr["y"], qr["chain"])
        Q2, R2 = np.linalg.qr(np.concatenate([qr["R"], B], axis=0))
        qr["R"] = R2
        qr["z"] = Q2.T @ np.concatenate([qr["z"], y_b])
        qr["y"] = y_new
        qr["fp"] = self._fv_fingerprint(y_new)
        self._fvqr_chain_step(qr, keep_prev=True)
        # one-deep undo: the accept/reject structure flow
        # (add_1atoms_fast, gppotential.py:888-940) pops the structure it
        # just added on reject — restoring the pre-append factor there is
        # exact and free, where a row DELETION downdate is not
        qr["prev"] = prev

    def _fvqr_retarget(self, y):
        """Refresh (z, y) for in-place target edits (head() swapping fake
        targets for exact ones) with the SAME covariance rows: corrected
        seminormal z = R^-T (K^T y) + one refinement pass — O(n m) vs the
        full rebuild a fingerprint miss would force."""
        qr = self._fvqr
        if qr is None:
            return None
        from scipy.linalg import solve_triangular

        K = self._fvqr_K()
        if len(y) != K.shape[0] or K.shape[1] != qr["R"].shape[1]:
            return None
        yn = max(float(np.linalg.norm(y)), 1e-300)
        try:
            z = np.zeros(qr["R"].shape[1])
            resid = np.asarray(y, dtype=np.float64).copy()
            ok = False
            for _ in range(4):  # CSNE refinement to convergence
                dz = solve_triangular(qr["R"].T, K.T @ resid, lower=True)
                if not np.all(np.isfinite(dz)):
                    return None
                z = z + dz
                resid = y - K @ solve_triangular(qr["R"], z, lower=False)
                if float(np.linalg.norm(dz)) <= 1e-13 * max(
                    float(np.linalg.norm(z)), yn
                ):
                    ok = True
                    break
            if not ok:
                return None  # non-contracting: R too ill-conditioned
        except np.linalg.LinAlgError:
            return None  # singular R: fall back to the full rebuild
        if not np.all(np.isfinite(z)):
            return None
        # for a faithful factor z = Q^T y, so ||z|| <= ||y||; amplification
        # beyond that means R does not factor the current K — a stale-z
        # seed here poisons the served solve (round-4 expr-kernel MAE 1e8)
        if float(np.linalg.norm(z)) > 1.01 * yn:
            return None
        qr["z"] = z
        qr["y"] = y
        qr["fp"] = self._fv_fingerprint(y)
        self._fvqr_chain_step(qr)
        return self._fvqr

    def _fvqr_pop_col(self):
        """Exact inverse of append (last column only).  Counts as a
        factor mutation: the one-deep row-append undo snapshot must not
        survive it (a later pop_1data restoring ``prev`` across a column
        pop would resurrect a factor with the wrong column count)."""
        qr = self._fvqr
        if qr is None:
            return
        if qr["R"].shape[1] < 1:
            self._fvqr = None
            return
        qr["R"] = qr["R"][:-1, :-1]
        qr["z"] = qr["z"][:-1]
        self._fvqr_chain_step(qr)

    def _fvqr_project(self, c):
        """Non-mutating projection of a would-be new fv column: returns
        ``(r, rho, zeta)`` — the R-column, the residual norm, and the
        projected-target entry the append WOULD produce — or None if the
        cache is absent / the column is degenerate."""
        qr = self._fvqr
        if qr is None:
            return None
        K = self._fvqr_K()
        if len(c) != K.shape[0] or K.shape[1] != qr["R"].shape[1]:
            return None
        return self._fvqr_project_on(K, c)

    # ------------------------------------------ incremental trial solve
    # The add_1inducing accept/reject test re-solves the WHOLE sgpr
    # system per candidate (reference gppotential.py:942-969 does too) —
    # three O(m^3) dense ops each (chol, inverse, stacked QR), which at
    # m~1000 makes the flagship sampling loop minutes-per-entry.  The
    # _sqr cache maintains the triangular factor of the stacked
    # least-squares system
    #     A = [Ke; R1; sigma L^T],   y = [e-residuals; z1; 0]
    # (exactly solver.solve_sgpr's seeded make_mu system) across
    # inducing appends:
    #   * column appends use CORRECTED SEMINORMAL projection —
    #     rs = Rs^-T (A^T c) — where A^T c is assembled from the block
    #     structure (Ke, the fv-QR R1, the Cholesky L), so no Q storage
    #     or row bookkeeping is needed;
    #   * the two structured new rows ([0..0,rho] -> zeta from the fv
    #     QR and [0..0,sigma*lam] -> 0 from L^T) fold into the bordered
    #     diagonal by explicit Givens algebra;
    #   * L / choli extend by one O(m^2) bordered row.
    # A trial therefore costs O(n m + m^2) and mutates NOTHING; a commit
    # applies the same pieces.  sigma (and the jitter-free chol) are
    # FROZEN at build time: the next full make_munu (every update's
    # optimize(), ioptim=1 default) rebuilds everything exactly, so the
    # approximation only perturbs which borderline candidates get
    # accepted (de threshold test), never the served model.
    def _sqr_ready(self):
        s = self._sqr
        return (
            self.m >= self.fast_trial_min_m
            and s is not None
            and s["sv"] == self.state_version
            and s["m"] == self.m
            and s["tv"] == self.target_version
            and self._fvqr is not None
            and self._fvqr["R"].shape[1] == self.m
            and len(self.mu) == self.m
        )

    def _sqr_build(self):
        """Build the stacked-system cache; returns it or None if the
        model is not in a fast-servable state (no data, degenerate M,
        fv cache refused)."""
        self._sqr = None
        if (self.m == 0 or self.m < self.fast_trial_min_m
                or self.ndata == 0 or len(self.mu) != self.m):
            return None
        y_fv = self._fv_targets()
        qr = self._fvqr
        if not (qr is not None and qr["fp"] == self._fv_fingerprint(y_fv)
                and qr["R"].shape[1] == self.m):
            qr = self._fvqr_build(
                np.concatenate([self.Kf, self.Kv], axis=0), y_fv
            )
        if qr is None:
            return None
        M = np.asarray(self.M, dtype=np.float64)
        L, ridge = solver.jitter_cholesky(M)
        if ridge > 0.0:
            return None  # unhealthy basis: let the full path jitter it
        choli = np.linalg.inv(L)
        sigma = solver.sigmoid(float(self.noise_state["all"])) * float(
            np.diag(M).mean()
        ) * 0.99
        energies, _, _ = self.targets()
        zlist, C = self.species_count_matrix()
        wvec = (np.array([self.mean_weights[z] for z in zlist])
                if zlist else np.zeros(0))
        mean_e = C @ wvec if len(zlist) else np.zeros(len(energies))
        residual = energies - mean_e
        A = np.concatenate([self.Ke, qr["R"], sigma * L.T], axis=0)
        ys = np.concatenate([residual, qr["z"], np.zeros(self.m)])
        Qs, Rs = np.linalg.qr(A)
        self._sqr = dict(
            R=Rs, z=Qs.T @ ys, L=L, choli=choli, sigma=sigma,
            resid=residual, m=self.m, sv=self.state_version,
            tv=self.target_version, chain=0,
        )
        return self._sqr

    def _sqr_trial(self, ke_col, c_fv, a, b):
        """Solve the bordered system for one candidate WITHOUT mutating
        any state.  Returns a dict of commit pieces (incl. the trial mu)
        or the string 'dependent' when the candidate is numerically in
        the span (the full path would jitter -> reference semantics
        reject it), or None when the fast path cannot serve."""
        from scipy.linalg import solve_triangular

        s = self._sqr
        proj = self._fvqr_project(c_fv)
        if proj is None:
            return "dependent"
        r, rho, zeta = proj
        l = s["choli"] @ a
        lam2 = float(b) - float(l @ l)
        if lam2 <= 1e-10 * max(float(b), 1.0):
            return "dependent"
        lam = float(np.sqrt(lam2))
        sigma = s["sigma"]
        # A^T c from the block structure (corrected seminormal)
        Atc = (self.Ke.T @ ke_col + self._fvqr["R"].T @ r
               + sigma * sigma * (s["L"] @ l))
        rs = solve_triangular(s["R"].T, Atc, lower=True)
        c2 = float(ke_col @ ke_col + r @ r + sigma * sigma * (l @ l))
        rho_s2 = c2 - float(rs @ rs)
        rho_s = float(np.sqrt(max(rho_s2, 0.0)))
        cty = float(ke_col @ s["resid"] + r @ self._fvqr["z"])
        if rho_s > 1e-9 * max(np.sqrt(c2), 1.0):
            zeta_s = (cty - float(rs @ s["z"])) / rho_s
        else:
            rho_s, zeta_s = 0.0, 0.0
        # fold the two structured new rows into the bordered diagonal
        d, t = rho_s, zeta_s
        for alpha, tau in ((rho, zeta), (sigma * lam, 0.0)):
            dn = float(np.hypot(d, alpha))
            t = (d * t + alpha * tau) / dn
            d = dn
        # RELATIVE dependence guard: column norms run O(1e2-1e3) with
        # pair terms, so an absolute 1e-12 floor lets near-dependent
        # candidates through and the seminormal solve explodes (measured:
        # mu overflow in the early-growth regime of rattled-crystal MD)
        if d <= 1e-8 * max(np.sqrt(c2), 1.0):
            return "dependent"
        x_last = t / d
        x_old = solve_triangular(s["R"], s["z"] - rs * x_last, lower=False)
        mu_t = np.concatenate([x_old, [x_last]])
        if not np.all(np.isfinite(mu_t)) or (
            float(np.abs(mu_t).max())
            > 1e6 * max(1.0, float(np.abs(self.mu).max()))
        ):
            return None  # ill-conditioned factor: full path + rebuild
        return dict(mu=mu_t, l=l, lam=lam, rs=rs, d=d, t=t)

    def _sqr_commit(self, env, a, blocks, trial):
        """Apply an accepted trial: matrix/QR/X appends via add_inducing
        (which also appends the fv-QR column), then extend the stacked
        factor, L/choli, and mu, and refresh stats/vscale."""
        s = self._sqr
        self.add_inducing(env, col=a, remake=False, blocks=blocks)
        m = self.m
        Rn = np.zeros((m, m))
        Rn[:-1, :-1] = s["R"]
        Rn[:-1, -1] = trial["rs"]
        Rn[-1, -1] = trial["d"]
        s["R"] = Rn
        s["z"] = np.concatenate([s["z"], [trial["t"]]])
        L = np.zeros((m, m))
        L[:-1, :-1] = s["L"]
        L[-1, :-1] = trial["l"]
        L[-1, -1] = trial["lam"]
        s["L"] = L
        ci = np.zeros((m, m))
        ci[:-1, :-1] = s["choli"]
        ci[-1, :-1] = -(trial["l"] @ s["choli"]) / trial["lam"]
        ci[-1, -1] = 1.0 / trial["lam"]
        s["choli"] = ci
        self.mu = trial["mu"]
        self.choli = ci
        self.ridge = 0.0
        self._model_arrays = None
        self.make_stats()
        s["m"] = m
        s["chain"] += 1
        s["sv"] = self.state_version
        # flag for callers that track covloss incrementally: this commit
        # EXTENDED choli by one bordered row (all previous rows intact),
        # so per-atom c updates as c += (cov @ choli[-1])^2 / alpha —
        # O(N m) instead of the O(N m^2) full recompute
        self._bordered_sv = self.state_version
        if s["chain"] > 1024:
            self._sqr = None  # bound seminormal drift; rebuild lazily

    def _fast_trial_pieces(self, env):
        """(a, b, blocks, c_fv) for a candidate env — the same device
        column work the slow path does, computed once."""
        if env.desc is None:
            self.stage_env(env)
        blocks = self._column_blocks(env, *self.engine.env_pair_data(env))
        ke_col, kf_col, kv_col = blocks
        kf_flat = np.concatenate(kf_col).reshape(-1)
        kv_flat = np.concatenate(kv_col).reshape(-1)
        c_fv = np.concatenate([kf_flat, kv_flat])
        a = self.kern_X_env(env)
        b = self.kern_env_env(env, env)
        return a, b, (np.asarray(ke_col).reshape(-1), kf_col, kv_col), c_fv

    def fast_add_inducing(self, env, col=None):
        """Unconditional-accept append with the incremental solve refresh
        (the update_lce beta-band branches); falls back to the full
        add_inducing + make_munu when the fast path cannot serve.
        Returns True when the incremental path was used."""
        if not self._sqr_ready():
            self._sqr_build()
        if not self._sqr_ready():
            self.add_inducing(env, col=col)
            return False
        a, b, blocks, c_fv = self._fast_trial_pieces(env)
        if col is not None:
            a = np.asarray(col).reshape(-1)
        ke_col = blocks[0]
        trial = self._sqr_trial(ke_col, c_fv, a, b)
        if trial is None:
            # ill-conditioned factor (not a dependent candidate): drop
            # the cache and take the exact path
            self._sqr = None
            self.add_inducing(env, col=a, blocks=blocks)
            return False
        if not isinstance(trial, dict):
            # dependent/degenerate: the full path would jitter; mimic its
            # observable outcome (ridge > 0 -> caller pops) cheaply
            self.add_inducing(env, col=a, remake=False, blocks=blocks)
            self.ridge = max(self.ridge, 1e-8)
            self._sqr = None
            return True
        self._sqr_commit(env, a, blocks, trial)
        return True

    def _fvqr_select(self, keep):
        """EXACT column-deletion update for an ASCENDING subset of
        inducing columns (downsize eviction): the LS system (K[:, keep],
        y) is equivalent to (R[:, keep], z), so one m x m' Householder QR
        of the staircase R[:, keep] re-triangularizes — O(m^2 m'), no Q
        storage, vs the O(n m^2) full refactorization (~11 s at the
        flagship scale) that invalidation would force on the next solve.
        Non-monotonic permutations (column reorders) drop the cache."""
        qr = self._fvqr
        if qr is None:
            return None
        keep = np.asarray(keep, dtype=int)
        m = qr["R"].shape[1]
        if keep.ndim != 1 or (len(keep) and (
                np.any(np.diff(keep) <= 0) or keep[0] < 0 or keep[-1] >= m)):
            return None
        if len(keep) == m:
            return qr
        if len(keep) == 0:
            return None
        Q2, R2 = np.linalg.qr(qr["R"][:, keep])
        return dict(R=R2, z=Q2.T @ qr["z"], y=qr["y"], fp=qr["fp"],
                    chain=qr.get("chain", 0) + 1)

    def kern_X_diag(self):
        """(m,) self-kernel k(x, x) of each inducing env, cached
        (invalidated whenever X changes); normalizes the near-duplicate
        guard of update_lce."""
        if self._xdiag is None or len(self._xdiag) != self.m:
            self._xdiag = np.array(
                [self.kern_env_env(x, x) for x in self.X]
            )
        return self._xdiag

    def _xstack_arrs(self):
        """Cached (desc stack, numbers, lone) of the inducing set —
        re-stacking the (m, D) descriptor matrix per kern_X_env call is
        an O(m D) copy paid once per sampling candidate (invalidated at
        every _xdiag site: X mutations and restaging)."""
        if self._xstack is None or (
                len(self._xstack[1]) != self.m):
            self._xstack = (
                np.stack([x.desc for x in self.X]),
                np.array([x.number for x in self.X]),
                np.array([x.lone for x in self.X]),
            )
        return self._xstack

    def kern_X_env(self, env: InducingEnv):
        """(m,) kernel column of env against the inducing set."""
        if self.m == 0:
            return np.zeros(0)
        Xd, zs, lo = self._xstack_arrs()
        if self.engine.chemical:
            central = self._chem_table()[zs, env.number]
        else:
            central = (zs == env.number).astype(np.float64)
        col = self._base_kernel(Xd @ env.desc) * central
        col = col + ((lo & env.lone) & (zs == env.number)) * 1.0
        if self.engine.pair_terms:
            from ..pairkernels import pair_kernel_env_vs_stage_np

            d2, m2 = self.pair_stage()
            col = col + pair_kernel_env_vs_stage_np(
                env, d2, m2, self.engine.pair_terms
            )
        return col

    # --------------------------------------------------- incremental updates
    def _data_fp(self):
        """Identity fingerprint of the data list — precomputed column
        blocks are valid only against the exact records they were
        computed for.  A monotonic mutation counter, NOT id()s: a popped
        record's address can be reused by a later allocation, which made
        an id-tuple fingerprint collide and serve stale kernel columns
        into Kf/Kv (round-4 water-dimer OTF poisoning)."""
        return (self._data_version, len(self.data))

    def _data_groups(self):
        """Record indices grouped by config shape (one column call each)."""
        groups: dict = {}
        for i, rec in enumerate(self.data):
            key = (rec.cfg.positions.shape, rec.cfg.nbr_idx.shape)
            groups.setdefault(key, []).append(i)
        return groups

    def precompute_column_blocks(self, envs):
        """Stage + compute _column_blocks for SEVERAL candidate envs in
        ONE host pull in total.  The greedy sampling loop stages a
        lookahead batch of argmax-β candidates anyway (update_inducing);
        the staged descriptors feed the column calls as device tensors (no
        intermediate pull), and a single device_fetch at the end pulls the
        staged descriptors plus all column chunks together."""
        envs = [e for e in envs if e is not None]
        if not envs:
            return
        eng = self.engine
        # -- descriptor staging on the device, no pull --
        todo = [e for e in envs if e.desc is None]
        staged_dev = [(chunk, *self._stage_dev(chunk))
                      for chunk in _chunks(todo, 256)]
        devrow = {}
        for ci, (chunk, _p, _l) in enumerate(staged_dev):
            for ri, e in enumerate(chunk):
                devrow[id(e)] = (ci, ri)
        flat = []  # device tensors for the single fetch, staging first
        for _c, p, lone in staged_dev:
            flat += [p, lone]

        def _finish_staging(bufs):
            # bufs alternate (p, lone) per staged chunk, already host-side
            for (chunk, _p, _l), p, lone in zip(
                    staged_dev, bufs[0::2], bufs[1::2]):
                p = p.astype(np.float64)
                for i, e in enumerate(chunk):
                    e.desc = p[i]
                    e.lone = bool(lone[i])

        if self.ndata == 0:
            if staged_dev:
                _finish_staging(device_fetch(*flat))
            return
        # evict entries whose data fingerprint went stale (they can never
        # be served) and bound the survivors by bytes: each entry is
        # O(3 natoms ndata) float64
        fp = self._data_fp()
        self._colcache = {
            k: v for k, v in self._colcache.items() if v[1] == fp
        }
        cache_bytes = sum(
            sum(np.asarray(col).nbytes for col in blocks[1] + blocks[2]
                if col is not None) + 8 * len(blocks[0])
            for (_e, _fp, blocks) in self._colcache.values()
        )
        if cache_bytes > 256 * 1024 * 1024 or len(self._colcache) > 256:
            self._colcache.clear()
        if eng.pair_terms:
            from ..pairkernels import stage_env_pairs

            for e in envs:
                eng.grow_pair_kx(e)
            # host-only inputs (rvec/numbers) — valid for unstaged envs
            pstage = [stage_env_pairs(e, eng.pair_terms, eng.pair_kx)
                      for e in envs]
            x_pds = np.stack([s[0] for s in pstage])
            x_pms = np.stack([s[1] for s in pstage])
        else:
            x_pds = x_pms = None

        def _desc_row(e):
            if e.desc is not None:
                return torch.as_tensor(np.asarray(e.desc), dtype=eng.model_dtype,
                                       device=eng.device)
            ci, ri = devrow[id(e)]
            return staged_dev[ci][1][ri]

        def _lone_row(e):
            if e.desc is not None:
                return torch.tensor(bool(e.lone), device=eng.device)
            ci, ri = devrow[id(e)]
            return staged_dev[ci][2][ri]

        n = self.ndata
        groups = self._data_groups()
        pending = []  # (echunk, data-chunk) per column call
        for echunk in _chunks(range(len(envs)), 8):
            ev = [envs[i] for i in echunk]
            descs = torch.stack([_desc_row(e) for e in ev])
            lones = torch.stack([_lone_row(e) for e in ev])
            nums = [e.number for e in ev]
            pd = x_pds[echunk] if x_pds is not None else None
            pm = x_pms[echunk] if x_pms is not None else None
            for key, idxs in groups.items():
                # bound the rows of one backward-kernel launch (envs x
                # configs x atoms) to ~32k
                cap = min(32, max(1, 32768 // max(len(ev) * int(key[0][0]), 1)))
                for chunk in _chunks(idxs, cap):
                    cfg_list = [self.data[i].cfg for i in chunk]
                    pending.append((echunk, chunk))
                    flat += list(eng.kernel_cols_multi(cfg_list, descs, nums,
                                                       lones, x_pds=pd,
                                                       x_pms=pm))
        # -- the ONE host pull: staging + every column chunk --
        bufs = device_fetch(*flat)
        _finish_staging(bufs[: 2 * len(staged_dev)])
        ke_all = {i: np.zeros(n) for i in range(len(envs))}
        kf_all: dict = {i: [None] * n for i in range(len(envs))}
        kv_all: dict = {i: [None] * n for i in range(len(envs))}
        o = 2 * len(staged_dev)
        for echunk, chunk in pending:
            keb, kfb, kvb = bufs[o], bufs[o + 1], bufs[o + 2]
            o += 3
            for j, i in enumerate(chunk):
                rec = self.data[i]
                for bi, eidx in enumerate(echunk):
                    ke_all[eidx][i] = keb[bi, j]
                    kf_all[eidx][i] = kfb[bi, j][: rec.natoms].reshape(-1)
                    kv_all[eidx][i] = voigt6(kvb[bi, j])
        for eidx, e in enumerate(envs):
            self._colcache[id(e)] = (
                e, fp, (list(ke_all[eidx]), kf_all[eidx], kv_all[eidx])
            )

    def _column_blocks(self, env: InducingEnv, x_pd=None, x_pm=None):
        """(Ke, Kf, Kv) column entries of one env against ALL data records:
        one column call and one pull per shape group of records, at most
        32k atom rows per call (the reference's per-structure loop,
        gppotential.py:746-752, without one call per record)."""
        hit = self._colcache.pop(id(env), None) if self._colcache else None
        if hit is not None and hit[0] is env and hit[1] == self._data_fp():
            return hit[2]
        n = self.ndata
        ke_col = np.zeros(n)
        kf_col: list = [None] * n
        kv_col: list = [None] * n
        for key, idxs in self._data_groups().items():
            cap = min(32, max(1, 32768 // max(int(key[0][0]), 1)))
            for chunk in _chunks(idxs, cap):
                cfg_list = [self.data[i].cfg for i in chunk]
                ke, kf, kv = device_fetch(*self.engine.kernel_col_batch(
                    cfg_list, env.desc, env.number, env.lone,
                    x_pd=x_pd, x_pm=x_pm,
                ))
                for j, i in enumerate(chunk):
                    rec = self.data[i]
                    ke_col[i] = ke[j]
                    kf_col[i] = kf[j][: rec.natoms].reshape(-1)
                    kv_col[i] = voigt6(kv[j])
        return list(ke_col), kf_col, kv_col

    def add_inducing(self, env: InducingEnv, col=None, remake=True,
                     blocks=None):
        """Append one inducing column (gppotential.py:745-771).
        ``blocks``: optional precomputed (ke_col, kf_col, kv_col) so the
        fast trial path does the device column work only once."""
        if env.desc is None:
            self.stage_env(env)
        if blocks is None:
            blocks = self._column_blocks(env, *self.engine.env_pair_data(env))
        ke_col, kf_col, kv_col = blocks
        a = self.kern_X_env(env) if col is None else np.asarray(col).reshape(-1)
        b = self.kern_env_env(env, env)
        m = self.m
        newM = np.zeros((m + 1, m + 1))
        newM[:m, :m] = self.M
        newM[:m, m] = a
        newM[m, :m] = a
        newM[m, m] = b
        self.M = newM
        if self.ndata:
            ke_col = np.asarray(ke_col).reshape(-1, 1)
            kf_col = np.concatenate(kf_col).reshape(-1, 1)
            kv_col = np.concatenate(kv_col).reshape(-1, 1)
            self.Ke = np.concatenate([self.Ke.reshape(self.ndata, m), ke_col], axis=1)
            self.Kf = np.concatenate([self.Kf.reshape(kf_col.shape[0], m), kf_col], axis=1)
            self.Kv = np.concatenate([self.Kv.reshape(kv_col.shape[0], m), kv_col], axis=1)
            self._fvqr_append_col(
                np.concatenate([kf_col[:, 0], kv_col[:, 0]])
            )
        else:
            self.Ke = np.zeros((0, m + 1))
            self.Kf = np.zeros((0, m + 1))
            self.Kv = np.zeros((0, m + 1))
        self.X.append(env)
        self._model_arrays = None
        self._pair_stage = None
        self._xdiag = None
        self._xstack = None
        if remake:
            self.make_munu()

    def add_data(self, rec: DataRecord, remake=True):
        """Append one structure's covariance rows (gppotential.py:728-743)."""
        if rec.cfg is None:
            rec.cfg = self.engine.make_config(rec.system)
        m = self.m
        if m:
            ke, kf, kv = device_fetch(
                *self.engine.kernel_block(rec.cfg, self.full_model_arrays())
            )
            ke = ke[: m].reshape(1, m)
            kf = kf[: rec.natoms, :, :m].reshape(-1, m)
            kv_t = kv[..., :m]  # (3, 3, m)
            kv = np.stack([kv_t[i, j] for (i, j) in
                           [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]])
        else:
            ke = np.zeros((1, 0))
            kf = np.zeros((3 * rec.natoms, 0))
            kv = np.zeros((6, 0))
        ne = self.Ke.shape[0] if self.Ke.size or self.Ke.shape[1] == m else 0
        self.Ke = np.concatenate([self.Ke.reshape(ne, m), ke], axis=0)
        nf = self.Kf.shape[0] if self.Kf.size or self.Kf.shape[1] == m else 0
        self.Kf = np.concatenate([self.Kf.reshape(nf, m), kf], axis=0)
        nv = self.Kv.shape[0] if self.Kv.size or self.Kv.shape[1] == m else 0
        self.Kv = np.concatenate([self.Kv.reshape(nv, m), kv], axis=0)
        # freshness of the cache w.r.t. the PRE-append targets: appending
        # rows onto a factor whose z corresponds to edited-in-place (not
        # yet retargeted) targets would stamp a stale z as fresh below
        fp_pre = (
            self._fvqr is not None
            and self._fvqr["fp"] == (self.target_version,
                                     len(self._fvqr["y"]))
        )
        self.data.append(rec)
        self._model_arrays = None
        self.target_version += 1
        self._data_version += 1
        if (m and fp_pre and self._fvqr is not None
                and self._fvqr["R"].shape[1] == m):
            # exact row-append keeps the fv-QR factor alive across
            # structure additions (the flagship loop adds one per FP call;
            # invalidation forced an O(n m^2) rebuild each time)
            y_new = self._fv_targets()
            nf = len(y_new) - 6 * self.ndata
            y_b = np.concatenate(
                [y_new[nf - 3 * rec.natoms: nf], y_new[-6:]]
            )
            self._fvqr_append_rows(
                np.concatenate([kf, kv], axis=0), y_b, y_new
            )
        else:
            self._fvqr = None
        if remake:
            self.make_munu()

    def solve_snapshot(self):
        """Copy of everything make_munu computes — for EXACT restore
        after a rejected trial data-add (add_1atoms_fast): add_data +
        pop_1data returns the data list to byte-identical content, so
        restoring the previous solve is equivalent to (and ~0.2 s/trial
        cheaper at flagship m than) the re-solve the reference performs
        (gppotential.py:888-940)."""
        return dict(
            mu=np.array(self.mu, copy=True),
            choli=np.array(self.choli, copy=True),
            ridge=self.ridge,
            noise_state=dict(self.noise_state),
            scaled_noise=dict(self.scaled_noise),
            mean_weights=dict(self.mean_weights),
            stats=dict(self.stats) if self.stats else self.stats,
            vscale=dict(self.vscale),
            indu_counts=dict(self.indu_counts),
            sqr=self._sqr,
            m=self.m,
        )

    def restore_solve(self, snap):
        """Restore a solve_snapshot taken at the same (X, data) content.
        Caller contract: the model's kernel matrices and data/X lists
        must be byte-identical to snapshot time (e.g. after an
        add_data + pop_1data round trip)."""
        if snap["m"] != self.m:
            self.make_munu()
            return
        self.mu = snap["mu"]
        self.choli = snap["choli"]
        self.ridge = snap["ridge"]
        self.noise_state = snap["noise_state"]
        self.scaled_noise = snap["scaled_noise"]
        self.mean_weights = snap["mean_weights"]
        self.stats = snap["stats"]
        self.vscale = snap["vscale"]
        self.indu_counts = snap["indu_counts"]
        sqr = snap["sqr"]
        if sqr is not None and sqr.get("m") == self.m:
            # content-identical model state: the factor is valid again;
            # re-stamp the version counters it is checked against
            sqr["sv"] = self.state_version
            sqr["tv"] = self.target_version
        self._sqr = sqr
        self._model_arrays = None
        self._bordered_sv = None  # never launder incremental covloss

    def pop_1data(self, remake=True, first=False):
        if not self.data:
            return
        self._data_version += 1
        if first:
            n0 = self.data[0].natoms
            self.Ke = self.Ke[1:]
            self.Kf = self.Kf[3 * n0:]
            self.Kv = self.Kv[6:]
            self.data.pop(0)
            self._fvqr = None  # head row deletion: no stable downdate
        else:
            n0 = self.data[-1].natoms
            self.Ke = self.Ke[:-1]
            self.Kf = self.Kf[: self.Kf.shape[0] - 3 * n0]
            self.Kv = self.Kv[:-6]
            self.data.pop()
            self.target_version += 1
            qr = self._fvqr
            prev = qr.get("prev") if qr is not None else None
            # the undo is valid ONLY if prev is byte-identical to the
            # system we just sliced back to: same column count AND same
            # target CONTENT (a length-only check laundered stale factors
            # when targets were edited in place between the append and
            # this pop — round-4 expr-kernel regression)
            if (
                prev is not None
                and prev[0].shape[1] == self.m
                and np.array_equal(prev[2], self._fv_targets())
            ):
                # exact undo of the matching row append (reject flow)
                qr["R"], qr["z"], qr["y"], qr["chain"] = prev
                qr["fp"] = self._fv_fingerprint(qr["y"])
                qr.pop("prev", None)
            else:
                self._fvqr = None
            if remake:
                self.make_munu()
            return
        self.target_version += 1
        if remake:
            self.make_munu()

    def pop_1inducing(self, remake=True, first=False):
        if not self.X:
            return
        if first:
            # head eviction is a column selection [1..m): exact R-mode
            # re-triangularization (None only if the cache was absent)
            self._fvqr = self._fvqr_select(np.arange(1, self.m))
        else:
            self._fvqr_pop_col()
        sl = slice(1, None) if first else slice(None, -1)
        self.Ke = self.Ke[:, sl]
        self.Kf = self.Kf[:, sl]
        self.Kv = self.Kv[:, sl]
        self.M = self.M[sl, sl]
        self.X.pop(0 if first else -1)
        self._model_arrays = None
        self._pair_stage = None
        self._xdiag = None
        self._xstack = None
        if remake:
            self.make_munu()

    def select_inducing(self, indices, remake=True):
        i = np.asarray(indices, dtype=int)
        self.Ke = self.Ke[:, i]
        self.Kf = self.Kf[:, i]
        self.Kv = self.Kv[:, i]
        self.M = self.M[np.ix_(i, i)]
        self.X = [self.X[j] for j in i]
        self._model_arrays = None
        self._pair_stage = None
        self._xdiag = None
        self._xstack = None
        self._fvqr = self._fvqr_select(i)
        if remake:
            self.make_munu()

    def downsize(self, max_data, max_inducing, lii=True, remake=True):
        """Evict oldest data / least-important inducing (gppotential.py:815-842)."""
        ch1 = 0
        while self.ndata > max_data:
            self.pop_1data(remake=False, first=True)
            ch1 += 1
        ch2 = 0
        if lii and max_inducing < self.m:
            order = np.argsort(self.M.sum(axis=1)).tolist()
            # sorted: the inducing order is internal (everything permutes
            # consistently), and an ascending keep-list makes the QR cache
            # update a pure column deletion (_fvqr_select)
            keep = sorted(order[: int(max_inducing)])
            self.select_inducing(keep, remake=False)
            ch2 = keep
        else:
            while self.m > max_inducing:
                self.pop_1inducing(remake=False, first=True)
                ch2 += 1
        if remake and (ch1 or ch2):
            self.make_munu()
        return ch1, ch2

    def rebuild_kernel_matrices(self, remake=True):
        """Re-derive ALL covariance blocks (M, Ke, Kf, Kv) from the stored
        raw data — the reference's full ``set_data`` build
        (gppotential.py:485-509).  Needed when the kernel itself changes
        (hyperparameter optimization, regression/hpo.py): every cached
        kernel value is stale then."""
        if self.X:
            # descriptors are kernel-parameter independent; only the
            # kernel values need recomputation
            self._pair_stage = None
            self._xdiag = None
            self._xstack = None
            M = np.zeros((self.m, self.m))
            for j, x in enumerate(self.X):
                M[:, j] = self.kern_X_env(x)
                M[j, j] = self.kern_env_env(x, x)
            self.M = 0.5 * (M + M.T)  # kern_X_env excludes the White diag
        self._model_arrays = None
        self._colcache = {}  # kernel values changed under the cache
        if self.ndata and self.m:
            data = self.data
            self.data = []
            self.Ke = np.zeros((0, self.m))
            self.Kf = np.zeros((0, self.m))
            self.Kv = np.zeros((0, self.m))
            self._fvqr = None
            for rec in data:
                self.add_data(rec, remake=False)
        if remake:
            self.make_munu()

    # ------------------------------------------------------------- the solve
    def targets(self):
        energies = np.array([rec.e for rec in self.data])
        forces = (
            np.concatenate([rec.f.reshape(-1) for rec in self.data])
            if self.data
            else np.zeros(0)
        )
        def _vir(rec):
            try:
                return rec.s * rec.system.volume
            except ValueError:  # non-periodic: stress rows are zeros
                return np.zeros(6)

        virials = (
            np.concatenate([_vir(rec) for rec in self.data])
            if self.data
            else np.zeros(0)
        )
        return energies, forces, virials

    def species_count_matrix(self):
        zlist = sorted(self.mean_weights.keys())
        C = np.zeros((self.ndata, len(zlist)))
        for i, rec in enumerate(self.data):
            cnt = rec.system.counts()
            for j, z in enumerate(zlist):
                C[i, j] = cnt.get(z, 0)
        return zlist, C

    def make_munu(self, optimize=False, noise_f=0.0):
        if self.m == 0 or self.ndata == 0:
            return
        # AutoMean.set_data: ensure a weight entry per species present
        for rec in self.data:
            for z in rec.system.numbers_set():
                self.mean_weights.setdefault(int(z), 0.0)
        energies, forces, virials = self.targets()
        zlist, C = self.species_count_matrix()
        natoms = np.array([rec.natoms for rec in self.data])
        # incremental QR: reuse/maintain the big-block factorization when
        # targets are unchanged and the column count matches (kept in sync
        # by add_inducing / pop_1inducing); otherwise rebuild it here
        y_fv = np.concatenate([forces, virials])
        fp = self._fv_fingerprint(y_fv)
        qr = self._fvqr
        if (qr is not None and qr["fp"] != fp
                and qr["R"].shape[1] == self.m
                and len(y_fv) == len(qr["y"])):
            # in-place retarget (head() fake->exact swap): same covariance
            # rows, new y — refresh z in O(n m) instead of rebuilding
            qr = self._fvqr_retarget(y_fv)
        if not (qr is not None and qr["fp"] == fp
                and qr["R"].shape[1] == self.m):
            qr = self._fvqr_build(self._fvqr_K(), y_fv)
        seed = (qr["R"], qr["z"]) if qr is not None else None
        res = solver.solve_sgpr(
            self.M, self.Ke, self.Kf, self.Kv,
            energies, forces, virials, natoms, C,
            self.noise_state, self.mean_weights,
            optimize=optimize, noise_f=noise_f, qr_seed=seed,
        )
        self.mu = res.mu
        self.choli = res.choli
        self.ridge = res.ridge
        self.noise_state = res.noise_state
        self.scaled_noise = res.scaled_noise
        self.mean_weights = {**self.mean_weights, **res.weights}
        self.make_stats()
        self._model_arrays = None
        # seed the incremental trial factor from the solve we just did
        # (solver returns its final stacked-QR triangle): the first
        # add_1inducing trial after a refit then skips the O(m^3)
        # _sqr_build re-factorization of the SAME system
        sqr = getattr(res, "sqr", None)
        if (sqr is not None and self.m >= self.fast_trial_min_m
                and self._fvqr is not None
                and self._fvqr["R"].shape[1] == self.m):
            self._sqr = dict(
                sqr, choli=np.asarray(self.choli, dtype=np.float64),
                m=self.m, sv=self.state_version,
                tv=self.target_version, chain=0,
            )
        else:
            self._sqr = None  # full solve supersedes the stale factor

    def optimize_model_parameters(self, noise_f=0.0):
        self.make_munu(optimize=True, noise_f=noise_f)

    def make_stats(self):
        """Fit errors + per-species predictive-variance scale
        (gppotential.py:610-649)."""
        energies, forces, virials = self.targets()
        zlist, C = self.species_count_matrix()
        wvec = np.array([self.mean_weights[z] for z in zlist]) if zlist else np.zeros(0)
        mean_e = C @ wvec if len(zlist) else np.zeros(len(energies))
        # NO stacked-K concatenate here: this runs once per accepted
        # inducing candidate (via the incremental commits), and the
        # (n, m) copy was pure churn — predict each block directly,
        # reusing the identity-cached [Kf; Kv] stack
        yy_e = self.Ke @ self.mu
        yy_fv = self._fvqr_K() @ self.mu
        n = self.ndata
        natoms = np.array([rec.natoms for rec in self.data], dtype=np.float64)
        ediff = (yy_e - (energies - mean_e)) / natoms
        yv = np.concatenate([forces, virials])
        fdiff = yy_fv - yv
        ss_res = (fdiff ** 2).sum()
        ss_tot = ((yv - yv.mean()) ** 2).sum()
        r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
        self.stats = dict(
            e_mean=float(ediff.mean()),
            e_mae=float(np.abs(ediff).mean()),
            f_mean=float(fdiff.mean()) if len(fdiff) else 0.0,
            f_mae=float(np.abs(fdiff).mean()) if len(fdiff) else 0.0,
            r2=float(r2),
        )
        # predictive-variance scale per species: mean of mu*(M@mu)
        q = self.mu * (self.M @ self.mu)
        numbers = np.array([x.number for x in self.X])
        self.vscale = {}
        self.indu_counts = {}
        for z in np.unique(numbers):
            sel = numbers == z
            self.vscale[int(z)] = float(q[sel].sum() / sel.sum())
            self.indu_counts[int(z)] = int(sel.sum())

    # ------------------------------------------------------------ predictive
    def leakage(self, env: InducingEnv):
        """Inducing-span residual of an env (gppotential.py:706-715)."""
        if env.desc is None:
            self.stage_env(env)
        a = self.kern_X_env(env)
        b = self.choli @ a
        c = float(b @ b)
        d = self.kern_env_env(env, env) + self.ridge
        return 1.0 - c / d

    def env_energy(self, env: InducingEnv):
        """GP energy of a single env (kernel part only; means cancel in
        the add_1inducing delta test, gppotential.py:959-962)."""
        return float(self.kern_X_env(env) @ self.mu)

    def add_1inducing(self, env, ediff, remake=True):
        """Accept env into the inducing set if it changes its own prediction
        by >= ediff (gppotential.py:942-969).

        The reject path RESTORES the pre-trial solve state instead of
        re-solving: pop slices the matrices back exactly, so the saved
        (mu, choli, stats, ...) are bit-identical to what a fresh
        make_munu would produce — and trial candidates dominate the
        sampling-loop wall at large m (one O(m^3) solve each)."""
        if env.desc is None:
            self.stage_env(env)
        if self.m == 0:
            self.add_inducing(env, remake=remake)
            return 1, float("inf")

        # incremental trial: O(n m + m^2), mutates nothing on reject
        if not self._sqr_ready():
            self._sqr_build()
        if self._sqr_ready():
            a, b, blocks, c_fv = self._fast_trial_pieces(env)
            trial = self._sqr_trial(blocks[0], c_fv, a, b)
            if trial is None:
                self._sqr = None  # ill-conditioned: exact path below
            elif trial == "dependent":
                return 0, 0.0
            if isinstance(trial, dict):
                e1 = float(a @ self.mu)
                e2 = float(np.concatenate([a, [b]]) @ trial["mu"])
                de = abs(e1 - e2)
                blind = abs(e1) < 1e-8 and abs(e2) < 1e-8
                if de < ediff and not blind:
                    return 0, de
                self._sqr_commit(env, a, blocks, trial)
                return 1, de

        e1 = self.env_energy(env)
        saved = self._solve_state()
        self.add_inducing(env, remake=True)
        e2 = self.env_energy(env)
        de = abs(e1 - e2)
        blind = abs(e1) < 1e-8 and abs(e2) < 1e-8
        if (de < ediff and not blind) or self.ridge > 0.0:
            self.pop_1inducing(remake=False)
            self._restore_solve_state(saved)
            return 0, de
        return 1, de

    def _solve_state(self):
        """Everything make_munu/make_stats assign — snapshotted before a
        trial inducing addition, restored on reject (subclasses extend).
        Arrays/dicts are copied defensively: correctness must not hinge on
        make_munu/make_stats never mutating them in place."""
        return (
            np.array(self.mu, copy=True), np.array(self.choli, copy=True),
            self.ridge, dict(self.noise_state),
            dict(self.scaled_noise), dict(self.mean_weights),
            dict(self.stats) if isinstance(self.stats, dict) else self.stats,
            dict(self.vscale), dict(self.indu_counts),
        )

    def _restore_solve_state(self, saved):
        (self.mu, self.choli, self.ridge, self.noise_state,
         self.scaled_noise, self.mean_weights, self.stats,
         self.vscale, self.indu_counts) = saved
        self._model_arrays = None

    def vscale_for(self, numbers):
        return np.array(
            [self.vscale.get(int(z), np.inf) for z in np.asarray(numbers)]
        )

    # --------------------------------------------------------------- device
    def full_model_arrays(self):
        """Padded device model state (cached until the model changes),
        in ``Engine.model_dtype``; the inducing capacity grows in powers
        of two from 32."""
        if self._model_arrays is None:
            m = self.m
            D = self.engine.dim
            Xd = (
                np.stack([x.desc for x in self.X])
                if m
                else np.zeros((0, D))
            )
            Xn = np.array([x.number for x in self.X], dtype=np.int32)
            Xl = np.array([x.lone for x in self.X], dtype=bool)
            mu = self.mu if len(self.mu) == m else np.zeros(m)
            ch = (
                self.choli
                if self.choli.shape == (m, m)
                else np.zeros((m, m))
            )
            mcap = max(self._mcap, 32)
            while mcap < m:
                mcap *= 2
            if self._mcap and mcap > self._mcap:
                # power-of-2 sticky growth: each transition changes the
                # inducing axis of every device tensor
                self.mcap_growth += 1
            self._mcap = mcap
            if self.engine.pair_terms:
                for x in self.X:
                    self.engine.grow_pair_kx(x)
            self._model_arrays = self.engine.model_arrays(
                Xd, Xn, Xl, mu, ch, mcap=mcap, envs=self.X
            )
        return self._model_arrays
