"""The port's engine, model loading and calculator against the JAX package
(CPU, float64), the device policy, and the port's import hygiene."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.io.model_io import load_model as jax_load_model
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch import resolve_device
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.engine import Engine, device_fetch, predict_fn
from autoforce_tpu_torch.io.convert import config_from_numpy, model_arrays_from_numpy
from autoforce_tpu_torch.io.model_io import load_model
from autoforce_tpu_torch.system import bulk_fcc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "baselines", "bench_model.pckl")
PARAMS = dict(lmax=2, nmax=2, rc=4.5)


def small_cu(reps=(2, 2, 2), seed=1):
    s = jax_bulk_fcc("Cu", 3.6).repeat(reps)
    s.rattle(0.05, seed=seed)
    return s


def small_model(eng, system, m=24, seed=0, choli_scale=0.02):
    """Random model arrays around the system's own descriptors (JAX side,
    as numpy): unit-norm X, weights mu, a lower-triangular choli."""
    rng = np.random.default_rng(seed)
    p, _ = eng.descriptors(eng.make_config(system))
    p = np.asarray(p)[: len(system)]
    X = p[rng.choice(len(system), m, replace=False)]
    X = X + 0.01 * rng.normal(size=X.shape)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    mu = 0.5 * rng.normal(size=m)
    choli = choli_scale * np.tril(rng.normal(size=(m, m)))
    return eng.model_arrays(X, np.full(m, 29, np.int32), np.zeros(m, bool), mu, choli)


def carry(cfg, ma):
    """JAX config and model arrays -> the port's, through io.convert."""
    tma = model_arrays_from_numpy(
        *(np.asarray(a) for a in (ma.X_desc, ma.X_num, ma.X_lone, ma.mu, ma.choli)),
        device="cpu", dtype=torch.float64, m_mask=np.asarray(ma.m_mask),
    )
    tcfg = config_from_numpy(*(None if a is None else np.asarray(a) for a in cfg),
                             device="cpu", dtype=torch.float64)
    return tcfg, tma


@pytest.fixture(scope="module")
def jax_setup():
    eng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4, species=[29])
    s = small_cu()
    cfg = eng.make_config(s)
    ma = small_model(eng, s)
    return eng, s, cfg, ma


def test_predict_matches_jax(jax_setup):
    eng, s, cfg, ma = jax_setup
    vs = np.full(cfg.npad, 1.3)
    e, f, w, cov, beta = eng.predict(cfg, ma, vs)
    tcfg, tma = carry(cfg, ma)
    radii = torch.as_tensor(np.array(eng.radii_table()))
    e2, f2, w2, cov2, beta2 = predict_fn(tcfg, tma, radii, torch.as_tensor(vs),
                                         SoapParams(**PARAMS), 4)
    np.testing.assert_allclose(float(e2), float(e), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f), atol=1e-9)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w), atol=1e-9)
    np.testing.assert_allclose(cov2.numpy(), np.asarray(cov), atol=1e-9)
    n = len(s)
    b, b2 = np.asarray(beta), beta2.numpy()
    assert 0 < b[:n].min() and np.isneginf(b2[n:]).all()
    np.testing.assert_allclose(b2[:n], b[:n], atol=1e-9)
    # the virial is symmetric and the forces sum to zero
    np.testing.assert_allclose(w2.numpy(), w2.numpy().T, atol=1e-12)
    np.testing.assert_allclose(f2.numpy().sum(0), 0.0, atol=1e-9)


def test_engine_make_config_matches_jax(jax_setup):
    eng, s, cfg, ma = jax_setup
    teng = Engine(params=SoapParams(**PARAMS), exponent=4, species=[29],
                  device="cpu", dtype=torch.float64)
    ts = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    ts.rattle(0.05, seed=1)
    tcfg = teng.make_config(ts)
    for name in ("positions", "cell", "numbers", "atom_mask", "nbr_idx",
                 "nbr_off", "nbr_sidx", "nbr_mask", "nbr_rev"):
        a, b = getattr(tcfg, name).numpy(), np.asarray(getattr(cfg, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    p, lone = teng.descriptors(tcfg)
    pj, lonej = eng.descriptors(cfg)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-10)
    np.testing.assert_array_equal(lone.numpy(), np.asarray(lonej))
    e, f, *_ = teng.predict(tcfg, carry(cfg, ma)[1], np.ones(tcfg.npad))
    ej, fj, *_ = eng.predict(cfg, ma, np.ones(cfg.npad))
    np.testing.assert_allclose(float(e), float(ej), rtol=1e-9)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), atol=1e-9)


def test_lone_atom_and_species_table():
    teng = Engine(params=SoapParams(**PARAMS), species=[29], device="cpu",
                  dtype=torch.float64)
    assert teng.ensure_species([29, 3]) and teng.species == [3, 29]
    assert not teng.ensure_species([3])
    np.testing.assert_array_equal(teng.species_index([3, 29, 8]), [0, 1, -1])
    np.testing.assert_array_equal(teng.znum_table().numpy(), [3, 29])
    envs = teng.make_envs([(np.zeros((0, 3)), np.zeros(0, int)),
                           (np.array([[2.0, 0.0, 0.0]]), np.array([29]))])
    p, lone = teng.env_descriptors(envs)
    np.testing.assert_array_equal(lone.numpy(), [True, False])
    assert p.shape == (2, teng.dim)


def test_load_model_restages_like_jax():
    jm = jax_load_model(MODEL)
    with np.load(os.path.join(MODEL, "inducing.npz")) as ind:
        ofs = np.concatenate([[0], np.cumsum(ind["counts"])])
        env_list = [(ind["rvec"][a:b], ind["numbers"][a:b])
                    for a, b in zip(ofs[:-1], ofs[1:])]
    pj, lonej = jm.engine.env_descriptors(jm.engine.make_envs(env_list))
    tm = load_model(MODEL, device="cpu", dtype=torch.float64)
    X = np.stack([x.desc for x in tm.X])
    np.testing.assert_allclose(X, np.asarray(pj), atol=1e-12)
    np.testing.assert_array_equal([x.lone for x in tm.X], np.asarray(lonej))
    np.testing.assert_array_equal(tm.mu, jm.mu)
    np.testing.assert_array_equal(tm.choli, jm.choli)
    assert tm.mean_weights == jm.mean_weights and tm.vscale == jm.vscale
    assert tm.engine.params.rc == jm.engine.params.rc
    assert tm.engine.species == jm.engine.species
    numbers = np.array([29, 29, 7])
    assert tm.mean_energy(numbers) == jm.mean_energy(numbers)
    np.testing.assert_array_equal(tm.vscale_for(numbers), jm.vscale_for(numbers))
    ma, jma = tm.full_model_arrays(), jm.full_model_arrays()
    assert ma.X_desc.shape == jma.X_desc.shape
    np.testing.assert_allclose(ma.X_desc.numpy(), np.asarray(jma.X_desc), atol=1e-12)


def test_calculator_matches_jax_calculator():
    from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc

    jm = jax_load_model(MODEL)
    jcalc = JaxCalc(covariance=jm, calculator=None, logfile=None, pckl=None,
                    tape=None, skin=0.5)
    js = small_cu(reps=(2, 2, 2), seed=4)
    js.calc = jcalc
    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=0.5,
                            device="cpu", dtype=torch.float64)
    ts = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    ts.rattle(0.05, seed=4)
    ts.calc = calc
    np.testing.assert_allclose(ts.get_potential_energy(),
                               js.get_potential_energy(), rtol=1e-10)
    np.testing.assert_allclose(ts.get_forces(), js.get_forces(), atol=1e-9)
    np.testing.assert_allclose(ts.get_stress(), js.get_stress(), atol=1e-9)
    assert calc.cfg.nbr_idx.shape[1] == jcalc.cfg.nbr_idx.shape[1]
    covloss = float(np.asarray(jcalc._host_beta()).max())
    np.testing.assert_allclose(float(calc.covlog), covloss, rtol=1e-8)


def test_calculator_refuses_an_oracle():
    with pytest.raises(NotImplementedError):
        ActiveCalculator(covariance=MODEL, calculator=object(), device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params=SoapParams(**PARAMS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(MODEL)
    assert resolve_device("cpu").type == "cpu"


def test_engine_refuses_unported_options():
    for kw in (dict(pair_terms=("x",)), dict(chemical="rbf"), dict(mesh=object()),
               dict(kernel="rbf")):
        with pytest.raises(NotImplementedError):
            Engine(device="cpu", **kw)


def test_device_fetch_round_trips_types():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    b = torch.tensor([True, False])
    c = torch.tensor(1.5, dtype=torch.float32)
    x, y, z = device_fetch(a, b, c)
    assert x.dtype == np.int32 and y.dtype == np.bool_ and z.dtype == np.float32
    np.testing.assert_array_equal(x, a.numpy())
    np.testing.assert_array_equal(y, b.numpy())
    assert float(z) == 1.5


def test_numerics_policy_disables_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, ROOT)
import autoforce_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "autoforce_tpu"
             or m.startswith("autoforce_tpu."))
assert not bad, bad
assert len(names) >= 20, names
print("ok", len(names))
""".replace("ROOT", repr(ROOT))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
