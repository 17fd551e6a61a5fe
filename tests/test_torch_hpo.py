"""The port's kernel HPO and exact GP against the JAX package (CPU,
float64): the energy and force-aware marginal likelihoods (value and
gradient at fixed parameters), the exact GP's blocks, LML and predictions,
the covariance rebuild after a kernel change, models with the whole kernel
space crossing between the packages, and short learning runs with a
kernel expression (with and without ``kernel_hpo``) making the same
sampling decisions in both packages."""

import os

import numpy as np
import pytest
import torch

import autoforce_tpu.kernelalgebra as jka
from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.io.model_io import load_model as jax_load_model
from autoforce_tpu.io.model_io import save_model as jax_save_model
from autoforce_tpu.md import VelocityVerlet as JaxVV
from autoforce_tpu.regression import exactgp as jgp
from autoforce_tpu.regression import hpo as jhpo
from autoforce_tpu.regression.sgpr import DataRecord as JaxRecord
from autoforce_tpu.regression.sgpr import SgprModel as JaxModel
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities
import autoforce_tpu_torch.kernelalgebra as tka
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.engine import Engine
from autoforce_tpu_torch.io.convert import sgpr_model_from_jax
from autoforce_tpu_torch.io.model_io import load_model, save_model
from autoforce_tpu_torch.md import VelocityVerlet
from autoforce_tpu_torch.regression import exactgp as tgp
from autoforce_tpu_torch.regression import hpo as thpo
from autoforce_tpu_torch.regression.sgpr import DataRecord, SgprModel
from test_torch_active import events, port_system
from test_torch_kernelspace import env_of, kernel_space_model

RC = 3.2
PARAMS = dict(lmax=2, nmax=2, rc=RC)
F64 = dict(device="cpu", dtype=torch.float64)
GAMMA = "Exp(Mul(Const(-1.0), Mul(SqD(), Positive({g!r}))))"
EXPRS = [
    GAMMA.format(g=0.5),
    "Add(Exp(Mul(Const(-1.0), Mul(SqD(), Positive(0.8)))), "
    "Mul(Const(0.01), White(1.0, False)))",
    "Add(Mul(Positive(0.7), Pow(DotProd(), 4.0)), White(0.1, True))",
]


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def lj_systems(n=4, seed0=200, rattle=0.08):
    out = []
    for k in range(n):
        s = jax_bulk_fcc("Cu", 3.6)
        s.rattle(rattle, seed=seed0 + k)
        s.calc = JaxLJ(epsilon=0.15, sigma=2.3, rc=RC)
        out.append(s)
    return out


def engines(kernel=None, species=(29,), **kw):
    jeng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4,
                     species=list(species),
                     kernel=None if kernel is None else (
                         kernel if kernel in ("rbf", "normed")
                         else jka.from_state(kernel)), **kw)
    teng = Engine(params=SoapParams(**PARAMS), exponent=4,
                  species=list(species),
                  kernel=None if kernel is None else (
                      kernel if kernel in ("rbf", "normed")
                      else tka.from_state(kernel)), **F64, **kw)
    return jeng, teng


def records(systems, cls):
    out = []
    for s in systems:
        sys_ = s if cls is JaxRecord else port_system(s)
        out.append(cls.from_system(sys_, energy=s.get_potential_energy(),
                                   forces=s.get_forces(),
                                   stress=np.zeros(6)))
    return out


# ------------------------------------------------------------ marginal LML


@pytest.mark.parametrize("state", EXPRS)
def test_energy_lml_value_and_gradient(state):
    rng = np.random.default_rng(0)
    S, n, D = 9, 5, 8
    P = rng.normal(size=(S, n, D))
    P /= np.linalg.norm(P, axis=-1, keepdims=True)
    Z = rng.choice([29, 47], size=(S, n)).astype(np.int32)
    mask = rng.random((S, n)) < 0.9
    y = rng.normal(size=S)
    je, te = jka.from_state(state), tka.from_state(state)
    q = np.asarray(je.params()) + 0.05
    jv, jg = jhpo.make_energy_lml(je, P, Z, mask, y, noise_e=0.05)(tuple(q))
    tv, tg = thpo.make_energy_lml(te, P, Z, mask, y, noise_e=0.05,
                                  device="cpu")(q)
    assert rel(tv, jv) < 1e-9
    assert rel(tg, jg) < 1e-9


@pytest.mark.parametrize("state", EXPRS)
def test_ef_lml_value_gradient_and_covariance(state):
    jeng, teng = engines()
    systems = lj_systems(3, seed0=300)
    jrec, trec = records(systems, JaxRecord), records(systems, DataRecord)
    means = np.array([0.3, -0.1, 0.2])
    je, te = jka.from_state(state), tka.from_state(state)
    q = np.asarray(je.params()) + 0.1
    jC = np.asarray(jhpo.ef_covariance_fn(je, jeng, jrec)(tuple(q)))
    tC = thpo.ef_covariance_fn(te, teng, trec)(torch.as_tensor(q))
    assert rel(tC.detach().numpy(), jC) < 1e-10
    jv, jg = jhpo.make_ef_lml(je, jeng, jrec, means, noise_e=1e-2,
                              noise_f=0.05)(tuple(q))
    tv, tg = thpo.make_ef_lml(te, teng, trec, means, noise_e=1e-2,
                              noise_f=0.05)(q)
    assert rel(tv, jv) < 1e-9
    assert rel(tg, jg) < 1e-9


def test_collect_dot_data_and_optimizers():
    jeng, teng = engines()
    systems = lj_systems(5, seed0=210)
    jrec, trec = records(systems, JaxRecord), records(systems, DataRecord)
    P1, Z1, m1 = jhpo.collect_dot_data(jeng, jrec)
    P2, Z2, m2 = thpo.collect_dot_data(teng, trec)
    np.testing.assert_allclose(P2, P1, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(Z2, Z1)
    np.testing.assert_array_equal(m2, m1)
    y = np.array([r.e for r in jrec]) - np.mean([r.e for r in jrec])
    je, te = jka.from_state(EXPRS[0]), tka.from_state(EXPRS[0])
    jn, jres = jhpo.optimize_expr(je, P1, Z1, m1, y, noise_e=0.05)
    tn, tres = thpo.optimize_expr(te, P2, Z2, m2, y, noise_e=0.05,
                                  device="cpu")
    # end points only loosely: L-BFGS stops at its own tolerance
    np.testing.assert_allclose(tn.params(), jn.params(), rtol=1e-3)
    assert tres.fun == pytest.approx(jres.fun, rel=1e-6)
    means = np.zeros(3)
    jn, _ = jhpo.optimize_expr_ef(je, jeng, jrec[:3], means, maxiter=20)
    tn, _ = thpo.optimize_expr_ef(te, teng, trec[:3], means, maxiter=20)
    np.testing.assert_allclose(tn.params(), jn.params(), rtol=1e-3)


# ------------------------------------------------------------------ exact GP


@pytest.mark.parametrize("kind", [None, "rbf", "normed", EXPRS[2]])
def test_exactgp_blocks_lml_and_prediction(kind):
    jeng, teng = engines(kind)
    systems = lj_systems(3, seed0=400)
    jc = [jeng.make_config(s) for s in systems[:2]]
    tc = [teng.make_config(port_system(s)) for s in systems[:2]]
    ref = jgp.cross_kernel_blocks(jc[0], jc[1], jeng.radii_table(),
                                  jeng.params, 4, kind=jeng.kernel_kind)
    got = tgp.cross_kernel_blocks(tc[0], tc[1], teng.radii_table(),
                                  teng.params, 4, kind=teng.kernel_kind)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()))
    jgpm = jgp.ExactGP(jeng, noise_e=1e-3, noise_f=1e-2)
    tgpm = tgp.ExactGP(teng, noise_e=1e-3, noise_f=1e-2)
    for r in records(systems[:2], JaxRecord):
        jgpm.add_data(r)
    for r in records(systems[:2], DataRecord):
        tgpm.add_data(r)
    assert rel(tgpm.covariance(), jgpm.covariance()) < 1e-10
    assert tgpm.log_marginal_likelihood() == pytest.approx(
        jgpm.log_marginal_likelihood(), rel=1e-9)
    probe = systems[2]
    je, jf, jve, jvf = jgpm.predict(probe, return_var=True)
    te, tf, tve, tvf = tgpm.predict(port_system(probe), return_var=True)
    assert te == pytest.approx(je, rel=1e-8, abs=1e-10)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-8)
    assert tve == pytest.approx(jve, rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(tvf, jvf, rtol=0, atol=1e-10)


# ------------------------------------------------------- covariance rebuild


def expr_model(eng, systems, cls_rec, model_cls):
    model = model_cls(eng)
    from autoforce_tpu.regression.sgpr import InducingEnv as JaxEnv
    from autoforce_tpu_torch.regression.sgpr import InducingEnv

    env_cls = JaxEnv if model_cls is JaxModel else InducingEnv
    for k in range(3):
        model.add_inducing(env_of(systems[k], k, env_cls), remake=False)
    for r in records(systems[:3], cls_rec):
        model.add_data(r, remake=False)
    model.make_munu()
    return model


def test_rebuild_kernel_matrices_matches_fresh_build():
    e1 = EXPRS[1]
    e2 = e1.replace("Positive(0.8)", "Positive(2.0)")
    systems = lj_systems(4)
    _, teng = engines(e1)
    model = expr_model(teng, systems, DataRecord, SgprModel)
    M0, Ke0, Kf0, mu0 = (model.M.copy(), model.Ke.copy(), model.Kf.copy(),
                         model.mu.copy())
    model.rebuild_kernel_matrices()
    np.testing.assert_allclose(model.M, M0, atol=1e-12)
    np.testing.assert_allclose(model.Ke, Ke0, atol=1e-12)
    np.testing.assert_allclose(model.Kf, Kf0, atol=1e-12)
    np.testing.assert_allclose(model.mu, mu0, atol=1e-9)
    teng.kernel_kind = tka.from_state(e2)
    model.rebuild_kernel_matrices()
    jeng2, teng2 = engines(e2)
    fresh = expr_model(teng2, systems, DataRecord, SgprModel)
    jfresh = expr_model(jeng2, systems, JaxRecord, JaxModel)
    for name in ("M", "Ke", "Kf", "Kv"):
        np.testing.assert_allclose(getattr(model, name), getattr(fresh, name),
                                   atol=1e-10)
        np.testing.assert_allclose(getattr(model, name), getattr(jfresh, name),
                                   atol=1e-10)
    np.testing.assert_allclose(model.mu, fresh.mu, atol=1e-8)


# ------------------------------------------------------ models cross over


def test_models_cross_between_the_packages(tmp_path):
    jm, systems = kernel_space_model()
    probe = systems[0].copy()
    probe.rattle(0.05, seed=3)
    jcalc = JaxCalc(covariance=jm, calculator=None, logfile=None, pckl=None,
                    tape=None)
    ref = jcalc.calculate(probe.copy())
    # JAX folder -> port
    jax_save_model(jm, str(tmp_path / "j.pckl"))
    tm = load_model(str(tmp_path / "j.pckl"), **F64)
    assert tm.engine.kernel_kind.state == jm.engine.kernel_kind.state
    assert tm.engine.chemical == "rbf" and len(tm.engine.pair_terms) == 1
    carried = sgpr_model_from_jax(jm, **F64)
    for model in (tm, carried):
        calc = ActiveCalculator(covariance=model, calculator=None,
                                logfile=None, pckl=None, tape=None)
        got = calc.calculate(port_system(probe))
        assert got["energy"] == pytest.approx(ref["energy"], abs=1e-8)
        np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-8)
        np.testing.assert_allclose(got["stress"], ref["stress"], atol=1e-8)
    # port folder -> JAX
    save_model(tm, str(tmp_path / "t.pckl"))
    jm2 = jax_load_model(str(tmp_path / "t.pckl"))
    assert jm2.engine.kernel_kind.state == jm.engine.kernel_kind.state
    assert jm2.engine.pair_terms == jm.engine.pair_terms
    got = JaxCalc(covariance=jm2, calculator=None, logfile=None, pckl=None,
                  tape=None).calculate(probe.copy())
    assert got["energy"] == pytest.approx(ref["energy"], abs=1e-8)
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-8)


# ------------------------------------------------- learning runs, both sides

RUN_KW = dict(ediff=0.01, ediff_tot=0.05, fdiff=0.05, ioptim=10**6, seed=0)


def learn(package, tmp, kernel_hpo=None, steps=20):
    """A short learning run (host velocity Verlet: no random numbers) of
    one package with the trainable-gamma kernel."""
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        s0 = jax_bulk_fcc("Cu", 3.6)
        s0.rattle(0.05, seed=1)
        maxwell_boltzmann_velocities(s0, 300, seed=2)
        if package == "jax":
            eng = JaxEngine(params=JaxSoapParams(lmax=2, nmax=2, rc=4.0),
                            exponent=4, kernel=jka.from_state(GAMMA.format(g=0.5)))
            calc = JaxCalc(covariance=JaxModel(eng),
                           calculator=JaxLJ(epsilon=0.15, sigma=2.3, rc=4.0),
                           logfile="active.log", pckl=None, tape=None,
                           kernel_hpo=kernel_hpo, **RUN_KW)
            s, VV = s0, JaxVV
        else:
            eng = Engine(params=SoapParams(lmax=2, nmax=2, rc=4.0), exponent=4,
                         kernel=tka.from_state(GAMMA.format(g=0.5)), **F64)
            calc = ActiveCalculator(
                covariance=SgprModel(eng),
                calculator=LennardJones(epsilon=0.15, sigma=2.3, rc=4.0),
                logfile="active.log", pckl=None, tape=None,
                kernel_hpo=kernel_hpo, **RUN_KW)
            s, VV = port_system(s0), VelocityVerlet
        s.calc = calc
        VV(s, 2 * units.fs).run(steps)
    finally:
        os.chdir(cwd)
    return calc, s


@pytest.mark.parametrize("kernel_hpo", [None, 1])
def test_learning_with_expression_kernel_same_decisions(tmp_path, kernel_hpo):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for pkg in ("jax", "torch"):
            d = tmp_path / pkg
            d.mkdir()
            out[pkg] = learn(pkg, str(d), kernel_hpo) + (str(d),)
    finally:
        torch.set_num_threads(threads)
    (jc, js, jd), (tc, ts, td) = out["jax"], out["torch"]
    je = events(os.path.join(jd, "active.log"))
    te = events(os.path.join(td, "active.log"))
    assert te == je and len(te) >= 2
    assert tc.size == jc.size
    if kernel_hpo:
        jlog = open(os.path.join(jd, "active.log")).read()
        tlog = open(os.path.join(td, "active.log")).read()
        assert tlog.count("kernel HPO") == jlog.count("kernel HPO") >= 1
        np.testing.assert_allclose(tc.engine.kernel_kind.params(),
                                   jc.engine.kernel_kind.params(), rtol=1e-3)
    assert np.isfinite(ts.positions).all()
