"""Host-side SGPR regression solve (float64, LAPACK).

A copy of ``autoforce_tpu/regression/solver.py`` (numpy and scipy only):
the port keeps its own host modules so that it never imports the JAX
package.

Mirrors the reference's default solver ``_regression``
(theforce/regression/gppotential.py:1204-1339): projected-process /
Titsias-style solve of

    [ K        ]        [ Y ]
    [ sigma L^T ] mu  =  [ 0 ]      via economy QR,

with K = [Ke; Kf; Kv], Y = [energy residuals; forces; virial*V; 0_m],
L = chol(M + ridge), sigma = sigmoid(s) * mean(diag M) * 0.99 (the
bounded noise reparametrization of gppotential.py:1178-1183, 1244-1252),
optional optimization of s to bias the force-fit MAE toward ``noise_f``,
and closed-form per-species mean weights (the reference optimizes the
same convex quadratic with scipy; we solve it exactly).

This is deliberately host/CPU work: the (n_targets+m) x m QR is tiny and
runs once per model update, exactly like the reference's rank-0 solve +
broadcast idiom (SURVEY.md §3.2).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize


def jitter_cholesky(M, jit=1e-6, jitbase=2.0):
    """Cholesky with geometric ridge escalation (algebra.py:29-47)."""
    M = np.asarray(M, dtype=np.float64)
    try:
        return np.linalg.cholesky(M), 0.0
    except np.linalg.LinAlgError:
        pass
    scale = float(np.diag(M).mean())
    if scale <= 0.0:
        scale = np.finfo(np.float64).eps
    ridge = jit * scale
    eye = np.eye(M.shape[0])
    while ridge <= scale:
        try:
            return np.linalg.cholesky(M + ridge * eye), ridge
        except np.linalg.LinAlgError:
            ridge *= jitbase
    raise np.linalg.LinAlgError("cholesky was not successful!")


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def logit(y):
    return np.log(y / (1.0 - y))


def qr_solve(A, Y):
    """Least-squares via economy QR (gppotential.py:1261-1263)."""
    Q, R = np.linalg.qr(A)
    return np.linalg.solve(R, Q.T @ Y)


class SolveResult:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def solve_sgpr(
    M,
    Ke,
    Kf,
    Kv,
    energies,
    forces_flat,
    virials_flat,
    natoms,
    species_counts,
    noise_state,
    mean_weights,
    optimize=False,
    noise_f=0.0,
    max_noise=0.99,
    qr_seed=None,
):
    """Full solve; returns SolveResult with mu, choli, ridge, sigma, weights.

    Args:
        M: (m, m) inducing Gram matrix.
        Ke/Kf/Kv: (n, m), (3N_tot, m), (6n, m) covariance blocks.
        energies/forces_flat/virials_flat: targets (virials = stress*V rows).
        natoms: (n,) atoms per structure.
        species_counts: (n, nz) per-structure species counts; columns ordered
            like ``zlist``.
        noise_state: dict {'all': s} unconstrained noise parameter(s).
        mean_weights: dict {z: w} per-species mean energy weights.
    """
    M = np.asarray(M, dtype=np.float64)
    m = M.shape[0]
    L, ridge = jitter_cholesky(M)
    choli = np.linalg.inv(L)
    scale = float(np.diag(M).mean()) * max_noise

    K_fv = np.concatenate([Kf, Kv], axis=0)
    Y_fv = np.concatenate([forces_flat, virials_flat])

    state = dict(noise_state)
    if "all" not in state:
        state["all"] = logit(0.01)

    # Seeded QR: factor the big (3N_tot + 6n) x m force/virial block ONCE;
    # every sigma (and the final energy-including solve) then reduces to a
    # small stacked QR of [<= n + m; R1; sigma L^T] — exactly the same
    # least-squares solution (||K x - Y||^2 = ||R1 x - Q1^T Y||^2 + const),
    # but the noise-optimization loop goes from O(n m^2) per iteration to
    # O(m^3) (the reference re-factors the full matrix each time,
    # gppotential.py:1261-1263).
    # qr_seed: (R1, z1) maintained incrementally by the caller across
    # inducing-column appends/pops (SgprModel._fvqr) — the sampling loop
    # then never refactors the big block at all
    if qr_seed is not None:
        R1, z1 = qr_seed
    elif K_fv.shape[0]:
        Q1, R1 = np.linalg.qr(K_fv)
        z1 = Q1.T @ Y_fv
    else:
        R1 = np.zeros((0, m))
        z1 = np.zeros(0)

    def make_mu(s, with_energies=None):
        sigma = sigmoid(s) * scale
        if with_energies is None:
            A = np.concatenate([R1, sigma * L.T], axis=0)
            Y = np.concatenate([z1, np.zeros(m)])
        else:
            A = np.concatenate([Ke, R1, sigma * L.T], axis=0)
            Y = np.concatenate([with_energies, z1, np.zeros(m)])
        return qr_solve(A, Y)

    if optimize:
        # Spectral form of make_mu for the sigma search: the ridge problem
        # min ||R1 x - z1||^2 + sigma^2 ||L^T x||^2 substitutes y = L^T x
        # (B = R1 L^-T, SVD'd ONCE) so every sigma costs O(m^2) instead of
        # a fresh O(m^3) QR — the scipy loop makes ~50 evaluations per
        # update, which made per-update noise optimization the dominant
        # active-learning cost at large m.  Identical solution to the
        # stacked QR (normal equations agree; equality-tested).
        choliT = choli.T
        B = R1 @ choliT
        U, S, Vt = np.linalg.svd(B, full_matrices=False)
        Uz = U.T @ z1
        VtcT = choliT @ Vt.T  # (m, k): maps spectral y -> x

        def mu_spectral(s):
            sigma = sigmoid(s) * scale
            return VtcT @ (S / (S * S + sigma * sigma) * Uz)

        def objective(x):
            mu = mu_spectral(float(x[0]))
            mae = np.abs(Kf @ mu - forces_flat).mean() if len(forces_flat) else 0.0
            return (mae - noise_f) ** 2

        res = minimize(objective, x0=[float(state["all"])])
        state["all"] = float(res.x[0])

    # ---- per-species mean weights (closed-form version of objective_mean,
    # gppotential.py:1313-1335: same convex quadratic, solved exactly).
    # The force-only mu feeding the weight fit is only needed when
    # optimizing — skipping it elsewhere halves the per-call QR cost
    # (the non-optimize path is the sampling loop's fallback trial)
    zlist = sorted(mean_weights.keys())
    weights = dict(mean_weights)
    if optimize and len(energies) and len(zlist):
        mu = make_mu(float(state["all"]))
        delta = energies - Ke @ mu
        C = species_counts / np.asarray(natoms, dtype=np.float64)[:, None]
        rhs = delta / np.asarray(natoms, dtype=np.float64)
        w, *_ = np.linalg.lstsq(C, rhs, rcond=None)
        weights = {z: float(w[i]) for i, z in enumerate(zlist)}

    # ---- final solve including energy residuals (gppotential.py:1337-1339)
    wvec = np.array([weights[z] for z in zlist]) if zlist else np.zeros(0)
    mean_e = species_counts @ wvec if len(zlist) else np.zeros(len(energies))
    residual = energies - mean_e
    sigma = sigmoid(float(state["all"])) * scale
    # inline make_mu(with_energies) keeping its triangular factor: the
    # caller seeds SgprModel._sqr with it, so the first incremental
    # inducing trial after a refit does NOT redo this O(m^3) QR
    A = np.concatenate([Ke, R1, sigma * L.T], axis=0)
    Y = np.concatenate([residual, z1, np.zeros(m)])
    Qs, Rs = np.linalg.qr(A)
    zs = Qs.T @ Y
    mu = np.linalg.solve(Rs, zs)

    return SolveResult(
        mu=mu,
        choli=choli,
        ridge=ridge,
        noise_state=state,
        scaled_noise={"all": float(sigma)},
        weights=weights,
        sqr=(None if ridge > 0.0
             else dict(R=Rs, z=zs, L=L, sigma=float(sigma),
                       resid=residual)),
    )
