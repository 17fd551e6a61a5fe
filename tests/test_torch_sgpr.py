"""The port's learning state against the JAX package (CPU, float64): the
engine's kernel columns and blocks, the SGPR solve on a state carried
across by ``io.convert.sgpr_model_from_jax``, the fv-QR / incremental
trial invariants, the one-pull contract of ``precompute_column_blocks``,
and model folders written by one package and read by the other."""

import numpy as np
import pytest
import torch

from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.engine import (
    kernel_block_fn,
    kernel_block_jac_fn,
    kernel_col_batch_fn,
    kernel_col_fn,
    kernel_cols_multi_fn,
)
from autoforce_tpu.io.model_io import load_model as jax_load_model
from autoforce_tpu.io.model_io import save_model as jax_save_model
from autoforce_tpu.neighbors import displacements, neighbor_table
from autoforce_tpu.regression.sgpr import DataRecord as JaxRecord
from autoforce_tpu.regression.sgpr import InducingEnv as JaxEnv
from autoforce_tpu.regression.sgpr import SgprModel as JaxModel
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.engine import Engine
from autoforce_tpu_torch.io.convert import (
    config_from_numpy,
    model_arrays_from_numpy,
    sgpr_model_from_jax,
)
from autoforce_tpu_torch.io.model_io import load_model, save_model
from autoforce_tpu_torch.regression import sgpr as sgpr_mod
from autoforce_tpu_torch.regression.sgpr import DataRecord, InducingEnv, SgprModel
from autoforce_tpu_torch.system import System, bulk_fcc
from test_fvqr_invariants import check_fvqr, check_served

RC = 4.5
PARAMS = dict(lmax=2, nmax=2, rc=RC)
F64 = dict(device="cpu", dtype=torch.float64)


def env_from(s, i, cls):
    t = neighbor_table(s.positions, s.cell, s.pbc, RC)
    r = displacements(s.positions, s.cell, t)
    m = t.mask[i]
    return cls.from_arrays(s.numbers[i], r[i][m], s.numbers[t.idx[i][m]])


def system(seed, rattle=0.05, species=(29,), reps=(2, 2, 2)):
    s = jax_bulk_fcc("Cu", 3.6).repeat(reps)
    if len(species) > 1:
        s.numbers[::3] = species[1]
    s.rattle(rattle, seed=seed)
    return s


def port_system(s):
    return System(numbers=s.numbers, positions=s.positions, cell=s.cell,
                  pbc=s.pbc)


def carry_cfg(cfg):
    return config_from_numpy(*(None if a is None else np.asarray(a) for a in cfg),
                             **F64)


# ------------------------------------------------------------------ columns


@pytest.fixture(scope="module", params=["one_species_rev", "two_species_scatter"])
def columns_case(request):
    species = (29,) if request.param == "one_species_rev" else (29, 47)
    je = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4, species=list(species))
    te = Engine(params=SoapParams(**PARAMS), exponent=4, species=list(species), **F64)
    cfgs = [je.make_config(system(s, species=species)) for s in (1, 2)]
    if request.param == "two_species_scatter":
        # no reverse slots: the scatter-add route of the neighbor sum
        cfgs = [c._replace(nbr_rev=None) for c in cfgs]
    p = np.asarray(je.descriptors(cfgs[0])[0])
    rng = np.random.default_rng(0)
    idx = rng.choice(32, 10, replace=False)
    X = p[idx] + 0.01 * rng.normal(size=(10, p.shape[1]))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Xn = np.asarray(cfgs[0].numbers)[idx]
    Xl = np.zeros(10, bool)
    Xl[3] = True  # a lone inducing env: the constant term of its column
    ma = je.model_arrays(X, Xn, Xl, rng.normal(size=10), np.eye(10))
    tma = model_arrays_from_numpy(
        *(np.asarray(a) for a in (ma.X_desc, ma.X_num, ma.X_lone, ma.mu, ma.choli)),
        m_mask=np.asarray(ma.m_mask), **F64)
    return je, te, cfgs, [carry_cfg(c) for c in cfgs], ma, tma, X, Xn, Xl


def assert_close(got, ref, tol=1e-10):
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * max(1.0, np.abs(r).max())


def test_gram_self_matches_jax(columns_case):
    je, te, cfgs, tcfgs, *_ = columns_case
    assert_close([te.gram_self(tcfgs[0])], [je.gram_self(cfgs[0])])


def test_kernel_col_and_batch_match_jax(columns_case):
    je, te, cfgs, tcfgs, ma, tma, X, Xn, Xl = columns_case
    r, p = je.radii_table(), je.params
    for j in (0, 3):
        ref = kernel_col_fn(cfgs[0], ma.X_desc[j], ma.X_num[j], ma.X_lone[j], r, p, 4)
        assert_close([t.numpy() for t in te.kernel_col(tcfgs[0], X[j], Xn[j], Xl[j])], ref)
        stacked = type(cfgs[0])(*(None if a is None else np.stack([np.asarray(a), np.asarray(b)])
                                  for a, b in zip(cfgs[0], cfgs[1])))
        ref = kernel_col_batch_fn(stacked, ma.X_desc[j], ma.X_num[j], ma.X_lone[j], r, p, 4)
        got = te.kernel_col_batch(tcfgs, X[j], Xn[j], Xl[j])
        assert_close([t.numpy() for t in got], ref)


def test_kernel_cols_multi_matches_jax(columns_case):
    je, te, cfgs, tcfgs, ma, tma, X, Xn, Xl = columns_case
    stacked = type(cfgs[0])(*(None if a is None else np.stack([np.asarray(a), np.asarray(b)])
                              for a, b in zip(cfgs[0], cfgs[1])))
    ref = kernel_cols_multi_fn(stacked, ma.X_desc[:5], ma.X_num[:5], ma.X_lone[:5],
                               je.radii_table(), je.params, 4)
    # the staged descriptors may come as device tensors
    got = te.kernel_cols_multi(tcfgs, torch.as_tensor(X[:5]), Xn[:5],
                               torch.as_tensor(Xl[:5]))
    assert_close([t.numpy() for t in got], ref)


@pytest.mark.parametrize("batch_size", [4, 64])
def test_kernel_block_matches_both_jax_routes(columns_case, batch_size):
    je, te, cfgs, tcfgs, ma, tma, *_ = columns_case
    got = [t.numpy() for t in te.kernel_block(tcfgs[0], tma, batch_size=batch_size)]
    r, p = je.radii_table(), je.params
    assert_close(got, kernel_block_fn(cfgs[0], ma, r, p, 4))
    assert_close(got, kernel_block_jac_fn(cfgs[0], ma, r, p, 4))


# -------------------------------------------------------- carried state


def jax_model(n_ind=6, n_data=3, seed0=0):
    eng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4, species=[29])
    model = JaxModel(eng)
    lj = JaxLJ(epsilon=0.15, sigma=2.3, rc=RC)
    for k in range(n_ind):
        model.add_inducing(env_from(system(seed0 + k, 0.07), k, JaxEnv), remake=False)
    for k in range(n_data):
        s = system(40 + k)
        s.calc = lj
        model.add_data(JaxRecord.from_system(s), remake=False)
    model.make_munu(optimize=True, noise_f=0.01)
    return model


@pytest.fixture(scope="module")
def carried():
    jm = jax_model()
    return jm, sgpr_model_from_jax(jm, **F64)


def test_carried_state_solves_like_jax(carried):
    jm, tm = carried
    assert tm.size == jm.size
    for name in ("M", "Ke", "Kf", "Kv"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    # the port's own staging reproduces the carried descriptors
    fresh = [InducingEnv.from_arrays(x.number, x.rvec, x.numbers) for x in tm.X]
    tm.stage_envs(fresh)
    for a, b in zip(fresh, jm.X):
        np.testing.assert_allclose(a.desc, b.desc, rtol=0, atol=1e-13)
    for mdl in (jm, tm):
        mdl._fvqr = mdl._sqr = None
        mdl.make_munu(optimize=True, noise_f=0.01)
    np.testing.assert_allclose(tm.mu, jm.mu, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm.choli, jm.choli, rtol=1e-10, atol=1e-12)
    assert tm.noise_state == pytest.approx(jm.noise_state, rel=1e-10)
    for k, v in jm.stats.items():
        assert tm.stats[k] == pytest.approx(v, rel=1e-8, abs=1e-12)


def test_growing_carried_state_matches_jax(carried):
    """add_inducing / add_data on both packages from one state: the new
    covariance columns and rows, then the solve, agree."""
    jm, tm = carried
    lj = JaxLJ(epsilon=0.15, sigma=2.3, rc=RC)
    s = system(77)
    jm.add_inducing(env_from(s, 5, JaxEnv))
    tm.add_inducing(env_from(s, 5, InducingEnv))
    s = system(78)
    s.calc = lj
    jm.add_data(JaxRecord.from_system(s))
    rec = JaxRecord.from_system(s)
    tm.add_data(DataRecord(system=port_system(rec.system), e=rec.e, f=rec.f,
                           s=rec.s, natoms=rec.natoms))
    for name in ("M", "Ke", "Kf", "Kv"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(b).max()), name
    np.testing.assert_allclose(tm.mu, jm.mu, rtol=1e-8, atol=1e-10)


# --------------------------------------------- fv-QR and fast trials (port)


def port_setup(seed):
    rng = np.random.RandomState(seed)
    model = SgprModel(Engine(params=SoapParams(**PARAMS), exponent=4,
                             species=[29], **F64))
    model.fast_trial_min_m = 0
    small = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    lj = LennardJones(epsilon=0.15, sigma=2.3, rc=RC)

    def rand_env(scale=None):
        s = small.copy()
        s.rattle((0.03 + 0.1 * rng.rand()) if scale is None else scale,
                 seed=rng.randint(10000))
        return env_from(s, rng.randint(len(s)), InducingEnv)

    def rand_rec(fake=False):
        s = small.copy()
        s.rattle(0.02 + 0.08 * rng.rand(), seed=rng.randint(10000))
        s.calc = lj
        rec = DataRecord.from_system(s)
        if fake:
            rec.e = rec.e + rng.randn()
            rec.f = rec.f + 0.1 * rng.randn(*rec.f.shape)
        return rec

    return rng, model, rand_env, rand_rec


@pytest.mark.parametrize("seed", [0, 1])
def test_fvqr_invariants_under_random_mutations(seed):
    """The randomized flow of tests/test_fvqr_invariants.py on the port."""
    rng, model, rand_env, rand_rec = port_setup(seed)
    for _ in range(4):
        model.add_inducing(rand_env(), remake=False)
    for _ in range(2):
        model.add_data(rand_rec(), remake=False)
    model.make_munu(optimize=True, noise_f=0.01)
    check_fvqr(model, "seed")
    for step in range(16):
        choice = rng.randint(9)
        if choice == 0:
            model.add_data(rand_rec(), remake=bool(rng.randint(2)))
        elif choice == 1 and model.ndata > 1:
            model.pop_1data(remake=bool(rng.randint(2)), first=bool(rng.randint(2)))
        elif choice == 2:
            model.add_inducing(rand_env(), remake=bool(rng.randint(2)))
        elif choice == 3 and model.m > 2:
            model.pop_1inducing(remake=bool(rng.randint(2)), first=bool(rng.randint(2)))
        elif choice == 4:
            if len(model.mu) != model.m:
                model.make_munu()
            model.add_1inducing(rand_env(), ediff=10 ** -rng.randint(6))
        elif choice == 5:
            if len(model.mu) != model.m:
                model.make_munu()
            model.fast_add_inducing(rand_env())
            if model.ridge > 0:
                model.pop_1inducing()
        elif choice == 6 and model.m > 3:
            keep = sorted(rng.choice(model.m, size=model.m - rng.randint(1, 3),
                                     replace=False).tolist())
            model.select_inducing(keep, remake=bool(rng.randint(2)))
        elif choice == 7:
            model.add_data(rand_rec(fake=True))
            if rng.randint(2):
                model.pop_1data()
            else:
                rec = model.data[-1]
                rec.e = rec.e + 0.5
                model.touch_targets()
                model.make_munu()
        else:
            model.make_munu(optimize=bool(rng.randint(2)), noise_f=0.01)
        check_fvqr(model, f"seed={seed} step={step}")
        if step % 5 == 4 and model.m and model.ndata:
            model.make_munu()
            check_served(model, f"seed={seed} step={step}")


def test_fast_trial_matches_full_solve():
    """tests/test_sgpr_fast.py on the port: the bordered incremental trial
    makes the same accept/reject decisions as the full per-trial solve,
    and an unconditional fast append serves the full solve's model."""
    _, fast, _, _ = port_setup(5)
    _, slow, _, _ = port_setup(5)
    for mdl in (fast, slow):
        for k in range(6):
            s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
            s.rattle(0.07, seed=k)
            mdl.add_inducing(env_from(s, k, InducingEnv), remake=False)
        for k in range(3):
            s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
            s.rattle(0.05, seed=40 + k)
            s.calc = LennardJones(epsilon=0.15, sigma=2.3, rc=RC)
            mdl.add_data(DataRecord.from_system(s), remake=False)
        mdl.make_munu(optimize=True, noise_f=0.01)
    slow._sqr_ready = lambda: False
    for k in range(6):
        s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
        s.rattle(0.03 + 0.04 * (k % 3), seed=70 + k)
        env = env_from(s, (5 * k) % 32, InducingEnv)
        a_f, _ = fast.add_1inducing(env, 1e-4)
        a_s, _ = slow.add_1inducing(
            env_from(s, (5 * k) % 32, InducingEnv), 1e-4)
        assert a_f == a_s
    assert fast.m == slow.m
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.06, seed=90)
    assert fast.fast_add_inducing(env_from(s, 3, InducingEnv)) is True
    slow.add_inducing(env_from(s, 3, InducingEnv))
    for mdl in (fast, slow):
        mdl._fvqr = mdl._sqr = None
    fast.noise_state = dict(slow.noise_state)
    fast.mean_weights = dict(slow.mean_weights)
    fast.make_munu(optimize=True, noise_f=0.01)
    slow.make_munu(optimize=True, noise_f=0.01)
    np.testing.assert_allclose(fast.mu, slow.mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fast.M, slow.M, rtol=1e-12, atol=1e-12)


def test_precompute_column_blocks_single_fetch(monkeypatch):
    """Staging + every candidate column in ONE device_fetch, with staged
    and unstaged candidates mixed, equal to the per-env paths."""
    _, model, rand_env, rand_rec = port_setup(3)
    for _ in range(4):
        model.add_inducing(rand_env(), remake=False)
    for _ in range(2):
        model.add_data(rand_rec(), remake=False)
    model.make_munu()
    envs = [rand_env() for _ in range(10)]  # two env chunks of at most 8
    model.stage_env(envs[1])
    model.stage_env(envs[3])
    ref_desc = {i: envs[i].desc.copy() for i in (1, 3)}
    calls = []
    real_fetch = sgpr_mod.device_fetch

    def counting_fetch(*arrays):
        calls.append(len(arrays))
        return real_fetch(*arrays)

    monkeypatch.setattr(sgpr_mod, "device_fetch", counting_fetch)
    model.precompute_column_blocks(envs)
    assert len(calls) == 1, calls
    monkeypatch.undo()
    fresh = [InducingEnv.from_arrays(e.number, e.rvec, e.numbers) for e in envs]
    model.stage_envs(fresh)
    for env, f in zip(envs, fresh):
        np.testing.assert_allclose(env.desc, f.desc, rtol=0, atol=1e-14)
        assert env.lone == f.lone
    for i in (1, 3):
        np.testing.assert_array_equal(envs[i].desc, ref_desc[i])
    for env in envs:
        got = model._column_blocks(env)  # served from the cache
        assert id(env) not in model._colcache
        ref = model._column_blocks(env)  # computed afresh
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-12, atol=1e-12)
        for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # a stale data fingerprint is never served
    env = rand_env()
    model.precompute_column_blocks([env])
    model.add_data(rand_rec(), remake=False)
    assert len(model._column_blocks(env)[0]) == model.ndata


# ------------------------------------------------------------ model folders


def test_folders_cross_between_packages(carried, tmp_path):
    jm = jax_model(n_ind=5, n_data=2, seed0=20)
    jdir = str(tmp_path / "jax.pckl")
    jax_save_model(jm, jdir)
    tm = load_model(jdir, **F64)
    jl = jax_load_model(jdir)  # the targets went through 12-digit extxyz
    assert tm.size == jm.size
    for name in ("M", "Ke", "Kf", "Kv", "mu", "choli"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    for a, b in zip(tm.X, jm.X):
        np.testing.assert_allclose(a.desc, b.desc, rtol=0, atol=1e-13)
    assert tm.mean_weights == jm.mean_weights
    assert tm.noise_state == jm.noise_state
    for k, v in jl.stats.items():
        assert tm.stats[k] == pytest.approx(v, rel=1e-9, abs=1e-12)
    for a, b in zip(tm.data, jl.data):
        np.testing.assert_allclose(a.system.positions, b.system.positions, atol=1e-10)
        np.testing.assert_allclose(a.f, b.f, atol=1e-10)

    tdir = str(tmp_path / "torch.pckl")
    tm.add_inducing(env_from(system(90), 2, InducingEnv))
    save_model(tm, tdir)
    back = jax_load_model(tdir)
    assert back.size == tm.size
    for name in ("M", "Ke", "Kf", "Kv", "mu", "choli"):
        np.testing.assert_array_equal(getattr(back, name), getattr(tm, name))
    assert back.vscale == pytest.approx(tm.vscale, rel=1e-12)
    again = load_model(tdir, **F64)
    for a, b in zip(again.X, back.X):
        np.testing.assert_allclose(a.desc, b.desc, rtol=0, atol=1e-13)


def test_overflowed_fvqr_residual_falls_back_to_a_fresh_build():
    """An inducing column appended through a near-singular fv-QR factor
    overflows its projection residual: the cache drops, the exact path
    rebuilds, and the model equals one built afresh from the same
    inducing set and data."""
    rng, model, rand_env, rand_rec = port_setup(3)
    for _ in range(4):
        model.add_inducing(rand_env(), remake=False)
    for _ in range(3):
        model.add_data(rand_rec(), remake=False)
    model.make_munu()
    assert model._fvqr is not None
    model._fvqr["R"][-1, -1] = 1e-300
    seen = []
    project = model._fvqr_project_on

    def spy(K, c):
        out = project(K, c)
        seen.append(out)
        return out

    model._fvqr_project_on = spy
    model.add_inducing(rand_env())
    assert seen == [None]
    assert np.isfinite(model.mu).all()
    check_fvqr(model, "after the overflow")
    fresh = SgprModel(model.engine)
    fresh.noise_state = dict(model.noise_state)
    fresh.mean_weights = dict(model.mean_weights)
    for env in model.X:
        fresh.add_inducing(env, remake=False)
    for rec in model.data:
        fresh.add_data(rec, remake=False)
    fresh.make_munu()
    np.testing.assert_allclose(model.mu, fresh.mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(model.choli, fresh.choli, rtol=1e-9, atol=1e-12)
