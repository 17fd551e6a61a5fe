"""Two questions about cross-species kernel entries (alchemical mixing,
pair terms), settled on the CPU against the JAX package (float64):

* a species' predictive-variance scale, the mean of mu * (M mu) over its
  inducing rows, can be negative once M has cross-species entries; then
  the β of that species' atoms is NaN, in both packages alike;
* a short on-the-fly learning run with the alchemical mixing and a Li-S
  pair term (64 atoms of the LGPS-like crystal, seeded, NVE, the trip
  armed) takes the same sampling decisions, sizes and weights in both
  packages once the JAX package's host k(x, x) (``_host_alpha``) includes
  the pair terms' k(P, P), as the port's does (the one departure of the
  port's learning with pair terms, ROADMAP §3).  The run is held up to the
  sampling event that makes the inducing matrix singular: there the two
  packages' matrices agree to 4e-15, but one Cholesky factorization
  fails and takes a ridge while the other succeeds, from rounding alone.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

import autoforce_tpu.engine as jengine
from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.calculator.oracles import MixtureLennardJones as JaxMixLJ
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.io.model_io import save_model as jax_save
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.pairkernels import PairTerm as JaxPairTerm
from autoforce_tpu.pairkernels import config_pair_mask, pair_diag
from autoforce_tpu.regression.sgpr import DataRecord as JaxRecord
from autoforce_tpu.regression.sgpr import InducingEnv as JaxEnv
from autoforce_tpu.regression.sgpr import SgprModel as JaxModel
from autoforce_tpu.system import maxwell_boltzmann_velocities
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.engine import Engine
from autoforce_tpu_torch.io.model_io import load_model
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.pairkernels import PairTerm
from autoforce_tpu_torch.tools.otf_bench import EPS, SIG

from test_torch_active import events, port_system
from test_torch_kernelspace import RC, SPECIES, env_of, make_system

F64 = dict(device="cpu", dtype=torch.float64)


def chemical_model():
    """A small JAX-package model with the alchemical mixing, learned from
    Lennard-Jones data on Cu-Ag systems: inducing rows of both species."""
    eng = JaxEngine(params=JaxSoapParams(lmax=2, nmax=2, rc=RC), exponent=4,
                    species=list(SPECIES), chemical="rbf")
    model = JaxModel(eng)
    systems = [make_system(10 + k) for k in range(2)]
    for s in systems:
        s.calc = JaxLJ(epsilon=0.15, sigma=2.3, rc=RC)
        for i in (0, 1, 3, 4):
            model.add_inducing(env_of(s, i, JaxEnv), remake=False)
    for s in systems:
        model.add_data(JaxRecord.from_system(s), remake=False)
    model.make_munu()
    return model


def test_negative_species_vscale_gives_nan_beta_in_both(tmp_path):
    """Weights with a cross-species term that outweighs a species' own:
    its vscale is negative and its atoms' β NaN, host and device, in both
    packages; the other species' β stays finite."""
    jm = chemical_model()
    path = str(tmp_path / "chem.pckl")
    jax_save(jm, path)
    tm = load_model(path, **F64)
    num = np.array([x.number for x in jm.X])
    A, B = SPECIES[1], SPECIES[0]
    a = int(np.flatnonzero(num == A)[0])
    rows_b = np.flatnonzero(num == B)
    M = np.asarray(jm.M)
    b = int(rows_b[np.argmax(M[a, rows_b])])
    assert M[a, b] > 0  # the alchemical mixing couples the species
    mu = np.zeros(jm.m)
    mu[a], mu[b] = 1.0, -2.0 * M[a, a] / M[a, b]
    vs = {}
    for name, model in (("jax", jm), ("port", tm)):
        model.mu = mu.copy()
        model._model_arrays = None
        model.make_stats()
        vs[name] = dict(model.vscale)
    assert vs["jax"][A] < 0 and vs["port"][A] < 0
    np.testing.assert_allclose(vs["port"][A], vs["jax"][A], rtol=1e-10)
    np.testing.assert_allclose(vs["port"][B], vs["jax"][B], rtol=1e-10)
    s0 = make_system(21, rattle=0.1)
    numbers = np.asarray(s0.numbers)
    betas = {}
    for name, cls, model, s in (("jax", JaxCalc, jm, s0.copy()),
                                ("port", ActiveCalculator, tm,
                                 port_system(s0))):
        calc = cls(covariance=model, calculator=None, logfile=None,
                   pckl=None, tape=None)
        s.calc = calc
        calc.calculate(s)
        padded = np.zeros(calc.cfg.positions.shape[0], dtype=np.int32)
        padded[: len(s)] = s.numbers
        dev = np.asarray(calc.engine.predict(
            calc.cfg, model.full_model_arrays(),
            model.vscale_for(padded))[4])
        betas[name] = (dev[: len(s)], calc._host_beta())
    for name, (dev, host) in betas.items():
        for beta in (dev, host):
            assert np.isnan(beta[numbers == A]).all(), name
            assert np.isfinite(beta[numbers == B]).all(), name
    for k in (0, 1):
        np.testing.assert_allclose(betas["port"][k][numbers == B],
                                   betas["jax"][k][numbers == B], atol=1e-10)


def jax_pair_self(calc):
    """The pair terms' k(P, P) of each atom of the calculator's current
    configuration, with the JAX package's functions."""
    cfg, eng = calc.cfg, calc.engine
    rvec = jengine._env_rvec(cfg.positions, cfg.cell, cfg)
    d = jnp.sqrt((rvec * rvec).sum(-1) + 1e-30)
    znum = eng.znum_table()
    nbrz = znum[jnp.clip(cfg.nbr_sidx, 0, znum.shape[0] - 1)]
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    out = 0.0
    for term in eng.pair_terms:
        m1 = config_pair_mask(term, cfg.numbers, nbrz, cfg.nbr_idx,
                              cfg.nbr_off, mask)
        out = out + pair_diag(d, m1, term)
    return np.asarray(out)[: len(calc.system)]


def lgps(seed=7):
    """64 atoms of the LGPS-like crystal (the OTF flagship's motif)."""
    from autoforce_tpu.system import bulk_fcc

    s = bulk_fcc("Cu", 3.7).repeat((2, 2, 2))
    s.numbers[:] = np.array([3, 16] * 13 + [15, 16, 15, 32, 16, 15])
    s = s.repeat((2, 1, 1))
    s.rattle(0.03, seed=seed)
    return s


def test_chemical_pair_learning_matches_jax(tmp_path, monkeypatch):
    host_alpha = JaxCalc._host_alpha

    def port_rule(self):
        return host_alpha(self) + jax_pair_self(self)

    monkeypatch.setattr(JaxCalc, "_host_alpha", port_rule)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    s0 = lgps()
    maxwell_boltzmann_velocities(s0, 300, seed=8)
    kw = dict(logfile="active.log", pckl=None, tape=None, ediff=0.02,
              ediff_tot=0.05, fdiff=0.08, noise_f=0.01, ioptim=10**6,
              skin=0.5)
    params = dict(lmax=2, nmax=2, rc=4.5)
    out = {}
    try:
        for name in ("jax", "port"):
            work = tmp_path / name
            work.mkdir()
            os.chdir(work)
            if name == "jax":
                eng = JaxEngine(params=JaxSoapParams(**params), exponent=4,
                                chemical="rbf",
                                pair_terms=(JaxPairTerm(a=3, b=16, rc=4.5),))
                calc = JaxCalc(covariance=eng, calculator=JaxMixLJ(
                    EPS, SIG, rc=4.5), **kw)
                s, D = s0.copy(), JaxDeviceMD
            else:
                eng = Engine(params=SoapParams(**params), exponent=4,
                             chemical="rbf",
                             pair_terms=(PairTerm(a=3, b=16, rc=4.5),), **F64)
                calc = ActiveCalculator(covariance=eng, calculator=(
                    MixtureLennardJones(EPS, SIG, rc=4.5)), **kw)
                s, D = port_system(s0), DeviceMD
            s.calc = calc
            dyn = D(s, calc, dt=2 * units.fs, chunk=10, thermostat="none")
            dyn.run(1)
            out[name] = (str(work), calc, s)
    finally:
        os.chdir(str(tmp_path))
        torch.set_num_threads(threads)
    (jt, jc, js), (tt, tc, ts) = out["jax"], out["port"]
    te = events(os.path.join(tt, "active.log"))
    assert te == events(os.path.join(jt, "active.log"))
    assert sum("added indu" in e for e in te) >= 3
    assert tc.size == jc.size and tc.size[1] >= 15
    # the compared window is well posed: the next sampling event of this
    # run adds an environment that leaves the inducing matrix singular
    # (smallest eigenvalue ~3e-17 of the largest), and whether its
    # Cholesky factor exists is then decided by rounding
    for m in (jc.model, tc.model):
        ev = np.linalg.eigvalsh(np.asarray(m.M))
        assert ev[0] > 1e-8 * ev[-1]
    np.testing.assert_allclose(tc.model.mu, jc.model.mu, rtol=0,
                               atol=1e-8 * np.abs(jc.model.mu).max())
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-8)
