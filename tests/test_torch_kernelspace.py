"""The port's kernel space against the JAX package (CPU, float64): kernel
expressions, the alchemical tables, pair terms, the engine's predict /
gram_self / columns / blocks under every kernel kind with chemical mixing
and pair terms, and the Jacobian route of ``kernel_block``."""

import numpy as np
import pytest
import torch

import autoforce_tpu.kernelalgebra as jka
import autoforce_tpu.pairkernels as jpk
from autoforce_tpu.chemical import atom_embeddings as j_embeddings
from autoforce_tpu.chemical import chem_rbf_table as j_chem_table
from autoforce_tpu.chemical import mixing_cholesky as j_mixing
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.engine import kernel_block_jac_fn as j_block_jac
from autoforce_tpu.neighbors import displacements, neighbor_table
from autoforce_tpu.regression.sgpr import InducingEnv as JaxEnv
from autoforce_tpu.regression.sgpr import SgprModel as JaxModel
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
import autoforce_tpu_torch.kernelalgebra as tka
import autoforce_tpu_torch.pairkernels as tpk
from autoforce_tpu_torch.chemical import atom_embeddings, chem_rbf_table, mixing_cholesky
from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.engine import (
    Engine,
    coeff_jacobian,
    gram_self_fn,
    kernel_block_fn,
    kernel_block_jac_fn,
    predict_fn,
)
from autoforce_tpu_torch.io.convert import config_from_numpy

RC = 4.0
PARAMS = dict(lmax=2, nmax=2, rc=RC)
SPECIES = (29, 47)
PAIR_TERMS = (
    dict(a=29, b=47, lengthscale=0.5, signal=0.3, rc=RC),
    dict(a=29, b=29, kind="logrbf", factor="repulsive", lengthscale=0.3,
         signal=0.2, rc=3.5, eta=2),
)
EXPRS = [
    "Add(Pow(DotProd(), 4.0), Mul(Const(0.01), White(1.0, False)))",
    "Exp(Mul(Const(-1.0), Mul(SqD(), Positive(0.5))))",
    "Mul(Positive(0.7), Exp(Mul(Const(-1.0), Mul(SqD(), Pow(Mul(Const(2.0), "
    "Mul(Positive(0.4), Positive(0.4))), -1.0)))))",
    "Add(Mul(Normed(), Positive(1.3)), Mul(Pow(DotProd(), 2.0), White(0.2, True)))",
]


def jexpr(state):
    return jka.from_state(state)


def texpr(state):
    return tka.from_state(state)


# ------------------------------------------------------------- kernel algebra


@pytest.mark.parametrize("state", EXPRS)
def test_kernel_expr_state_values_and_gradients(state):
    je, te = jexpr(state), texpr(state)
    assert te.state == je.state == state
    assert jka.from_state(te.state) == je and tka.from_state(je.state) == te
    assert np.allclose(te.params(), je.params(), rtol=0, atol=0)
    t = np.linspace(-0.9, 0.99, 13)
    np.testing.assert_allclose(
        te.value(torch.as_tensor(t)).numpy(), np.asarray(je.value(t)),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(te.white_diag(xp=np)),
                               float(je.white_diag(xp=np)), rtol=1e-13)
    # parameter gradients: torch autograd against jax.grad
    import jax
    import jax.numpy as jnp

    q0 = np.asarray(je.params()) + 0.1
    if q0.size == 0:
        return

    def jf(q):
        return (je.value_with_params(jnp.asarray(t), tuple(q), xp=jnp).sum()
                + je._white(list(q), jnp))

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(q0))
    q = torch.as_tensor(q0).requires_grad_(True)
    tv = (te.value_with_params(torch.as_tensor(t), list(q)).sum()
          + te._white(list(q), torch))
    (tg,) = torch.autograd.grad(tv, q)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-11, atol=1e-13)
    assert te.with_params(q0.tolist()).state == je.with_params(q0.tolist()).state


def test_kernel_expr_operators_and_rbf():
    a = tka.DotProd() ** 4 + 0.01 * tka.White()
    b = jka.DotProd() ** 4 + 0.01 * jka.White()
    assert a.state == b.state
    for tr in (False, True):
        assert tka.RBF(0.7, tr).state == jka.RBF(0.7, tr).state
    c = -(tka.SqD() / tka.Positive(0.5)) - 1.5
    d = -(jka.SqD() / jka.Positive(0.5)) - 1.5
    assert c.state == d.state


# ------------------------------------------------------- chemical and pairs


def test_chem_tables_agree():
    np.testing.assert_array_equal(atom_embeddings(), j_embeddings())
    np.testing.assert_array_equal(chem_rbf_table(), j_chem_table())
    for sp in ([29], [3, 16], [3, 15, 16, 32]):
        np.testing.assert_array_equal(mixing_cholesky(sp), j_mixing(sp))


def _pair_inputs(seed=0, n=12, k=9):
    rng = np.random.default_rng(seed)
    numbers = rng.choice([3, 16, 29], size=n).astype(np.int32)
    nbr_idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr_numbers = numbers[nbr_idx]
    nbr_off = rng.integers(-1, 2, size=(n, k, 3)).astype(np.int32)
    nbr_off[::3, ::2] = 0
    nbr_mask = rng.random((n, k)) < 0.8
    d = rng.uniform(0.5, 6.5, size=(n, k))
    return numbers, nbr_numbers, nbr_idx, nbr_off, nbr_mask, d


@pytest.mark.parametrize("term", [
    dict(a=3, b=16, rc=6.0),
    dict(a=29, b=29, kind="logrbf", factor="repulsive", eta=2, rc=5.0,
         lengthscale=0.4, signal=0.7),
    dict(a=3, b=29, factor=None, lengthscale=2.0),
])
def test_pair_masks_gram_and_diag_agree(term):
    jt, tt = jpk.PairTerm(**term), tpk.PairTerm(**term)
    numbers, nbrz, idx, off, mask, d = _pair_inputs()
    jm = np.asarray(jpk.config_pair_mask(jt, numbers, nbrz, idx, off, mask))
    tm = tpk.config_pair_mask(tt, *(torch.as_tensor(a) for a in
                                     (numbers, nbrz, idx, off, mask)))
    np.testing.assert_array_equal(tm.numpy(), jm)
    je = np.asarray(jpk.env_pair_mask(jt, 16, nbrz[0], mask[0]))
    te = tpk.env_pair_mask(tt, torch.tensor(16), torch.as_tensor(nbrz[0]),
                           torch.as_tensor(mask[0]))
    np.testing.assert_array_equal(te.numpy(), je)
    _, _, _, _, m2, d2 = _pair_inputs(seed=1, n=70, k=7)
    jg = np.asarray(jpk.pair_gram(d, jm, d2, m2, jt))
    tg = tpk.pair_gram(torch.as_tensor(d), tm, torch.as_tensor(d2),
                       torch.as_tensor(m2), tt)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        tpk.pair_diag(torch.as_tensor(d), tm, tt).numpy(),
        np.asarray(jpk.pair_diag(d, jm, jt)), rtol=1e-12, atol=1e-13)


# ------------------------------------------------------------------ engine


def make_system(seed, reps=(2, 2, 2), rattle=0.06):
    s = jax_bulk_fcc("Cu", 3.6).repeat(reps)
    s.numbers[::3] = SPECIES[1]
    s.rattle(rattle, seed=seed)
    return s


def env_of(s, i, cls):
    t = neighbor_table(s.positions, s.cell, s.pbc, RC)
    r = displacements(s.positions, s.cell, t)
    m = t.mask[i]
    return cls.from_arrays(s.numbers[i], r[i][m], s.numbers[t.idx[i][m]])


CASES = {
    "dot": dict(),
    "rbf": dict(kernel="rbf"),
    "normed": dict(kernel="normed"),
    "expr": dict(kernel=EXPRS[0]),
    "chem": dict(chemical="rbf"),
    "chem_normed": dict(chemical="rbf", kernel="normed"),
    "pairs": dict(pair_terms=True),
    "all": dict(chemical="rbf", kernel=EXPRS[1], pair_terms=True),
}


def engines(case):
    """(JAX engine, port engine) of one kernel configuration."""
    kw = dict(CASES[case])
    kind = kw.pop("kernel", None)
    pairs = kw.pop("pair_terms", False)
    jkw = dict(kw, kernel=None if kind is None or kind in ("rbf", "normed")
               else jexpr(kind))
    tkw = dict(kw, kernel=None if kind is None or kind in ("rbf", "normed")
               else texpr(kind))
    if kind in ("rbf", "normed"):
        jkw["kernel"] = tkw["kernel"] = kind
    if pairs:
        jkw["pair_terms"] = tuple(jpk.PairTerm(**t) for t in PAIR_TERMS)
        tkw["pair_terms"] = tuple(tpk.PairTerm(**t) for t in PAIR_TERMS)
    jeng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4,
                     species=list(SPECIES), **jkw)
    teng = Engine(params=SoapParams(**PARAMS), exponent=4,
                  species=list(SPECIES), device="cpu", dtype=torch.float64,
                  **tkw)
    return jeng, teng


def model_of(jeng, teng, m=10, seed=0):
    """The same random model (staged envs from rattled systems, weights,
    choli) in both packages' model arrays."""
    rng = np.random.default_rng(seed)
    jm = JaxModel(jeng)
    envs = [env_of(make_system(100 + i), int(rng.integers(0, 32)), JaxEnv)
            for i in range(m)]
    jm.stage_envs(envs)
    X = np.stack([e.desc for e in envs])
    num = np.array([e.number for e in envs], np.int32)
    lone = np.array([e.lone for e in envs])
    mu = 0.3 * rng.normal(size=m)
    choli = 0.02 * np.tril(rng.normal(size=(m, m)))
    for e in envs:
        jeng.grow_pair_kx(e) if jeng.pair_terms else None
    teng.pair_kx = jeng.pair_kx
    jma = jeng.model_arrays(X, num, lone, mu, choli, envs=envs)
    tma = teng.model_arrays(X, num, lone, mu, choli, envs=envs)
    return envs, jma, tma


def carry_cfg(cfg):
    return config_from_numpy(*(None if a is None else np.asarray(a) for a in cfg),
                             device="cpu", dtype=torch.float64)


def close(a, b, atol=1e-10):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_kernel_space_agrees(case):
    jeng, teng = engines(case)
    s = make_system(1)
    jcfg = jeng.make_config(s)
    tcfg = carry_cfg(jcfg)
    envs, jma, tma = model_of(jeng, teng)
    vs = np.full(jcfg.npad, 1.7)
    # predict
    got = predict_fn(tcfg, tma, teng.radii_table(), torch.as_tensor(vs),
                     teng.params, 4, ks=teng.kernel_space())
    ref = jeng.predict(jcfg, jma, vs)
    for a, b in zip(got[:4], ref[:4]):
        close(a, b)
    n = len(s)
    close(got[4][:n], np.asarray(ref[4])[:n])
    # descriptors and staging (mixed with chemical)
    close(teng.descriptors(tcfg)[0], jeng.descriptors(jcfg)[0])
    # gram_self
    close(gram_self_fn(tcfg, teng.radii_table(), teng.params, 4,
                       ks=teng.kernel_space()), jeng.gram_self(jcfg))
    # columns of three envs against two configs, with their pair sets
    s2 = make_system(2)
    jcfgs = [jcfg, jeng.make_config(s2, npad=jcfg.npad,
                                    kpad=jcfg.nbr_idx.shape[1])]
    tcfgs = [carry_cfg(c) for c in jcfgs]
    pick = envs[:3]
    pds = pms = None
    if jeng.pair_terms:
        st = [jeng.env_pair_data(e) for e in pick]
        pds, pms = np.stack([a for a, _ in st]), np.stack([b for _, b in st])
    x = np.stack([e.desc for e in pick])
    nums = [e.number for e in pick]
    lones = [e.lone for e in pick]
    ref = jeng.kernel_cols_multi(jcfgs, x, nums, lones, x_pds=pds, x_pms=pms)
    got = teng.kernel_cols_multi(tcfgs, x, nums, lones, x_pds=pds, x_pms=pms)
    for a, b in zip(got, ref):
        close(a, b)
    # the block against the whole inducing set (the column route)
    ref = jeng.kernel_block(jcfg, jma, method="vjp")
    got = kernel_block_fn(tcfg, tma, teng.radii_table(), teng.params, 4,
                          batch_size=4, ks=teng.kernel_space())
    for a, b in zip(got, ref):
        close(a, b)


def test_kernel_block_jac_route():
    """The Jacobian route against JAX's ``kernel_block_jac_fn`` and the
    port's column route (the JAX package's own bound for its two routes,
    tests/test_engine.py)."""
    jeng, teng = engines("dot")
    s = make_system(3)
    jcfg = jeng.make_config(s)
    tcfg = carry_cfg(jcfg)
    _, jma, tma = model_of(jeng, teng, m=12, seed=4)
    ref = j_block_jac(jcfg, jma, jeng.radii_table(), jeng.params, 4)
    col = teng.kernel_block(tcfg, tma, method="vjp")
    sk.soap_coeff_bwd.launches = 0
    got = kernel_block_jac_fn(tcfg, tma, teng.radii_table(), teng.params, 4,
                              chunk=5)
    for a, b, c in zip(got, ref, col):
        close(a, b, atol=1e-9)
        close(a, c, atol=1e-9)
    jac = teng.kernel_block(tcfg, tma, method="jac")
    for a, b in zip(jac, got):
        close(a, b, atol=1e-12)
    with pytest.raises(ValueError):
        engines("chem")[1].kernel_block(tcfg, tma, method="jac")


def test_kernel_block_auto_takes_the_jacobian_at_64():
    jeng, teng = engines("dot")
    tcfg = carry_cfg(jeng.make_config(make_system(5)))
    calls = []
    import autoforce_tpu_torch.engine as te

    real = te.kernel_block_jac_fn

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    te.kernel_block_jac_fn = spy
    try:
        for m, want in ((63, 0), (64, 1)):
            _, _, tma = model_of(jeng, teng, m=m, seed=m)
            teng.kernel_block(tcfg, tma)
            assert len(calls) == want
        _, teng_chem = engines("chem")
        teng_chem.kernel_block(tcfg, tma)
        assert len(calls) == 1
    finally:
        te.kernel_block_jac_fn = real


def test_coeff_jacobian_against_autograd():
    """The one-hot launch gives d c[i, s_k, q] / d rvec[i, k]."""
    rng = np.random.default_rng(2)
    N, K, S = 5, 7, 2
    p = SoapParams(lmax=2, nmax=1, rc=RC)
    rvec = torch.as_tensor(rng.uniform(-2.5, 2.5, (N, K, 3)))
    sidx = torch.as_tensor(rng.integers(0, S, (N, K)), dtype=torch.int32)
    mask = torch.as_tensor(rng.random((N, K)) < 0.85)
    radii = torch.tensor([1.0, 1.3], dtype=torch.float64)
    jc = coeff_jacobian(rvec, sidx, mask, radii, p)
    Q = (p.nmax + 1) * (p.lmax + 1) ** 2
    for ri in range(2):
        for q in (0, 5, Q - 1):
            rv = rvec.clone().requires_grad_(True)
            cr, ci = sk.soap_coeff_fwd_plain(rv, sidx, mask, radii, p)
            c = (cr, ci)[ri].reshape(N, S, Q)[:, :, q]  # (N, S)
            for i in range(N):
                for s in range(S):
                    (g,) = torch.autograd.grad(c[i, s], rv, retain_graph=True)
                    sel = (sidx[i] == s) & mask[i]
                    close(jc[ri, q, i][sel], g[i][sel], atol=1e-12)


# ------------------------------------------------------------- the drivers


def kernel_space_model():
    """A small trained JAX-package model with a KernelExpr (with White),
    a Cu-Ag pair term and the alchemical mixing, and its systems."""
    from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
    from autoforce_tpu.regression.sgpr import DataRecord as JaxRecord

    jeng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4,
                     species=list(SPECIES), chemical="rbf",
                     kernel=jexpr("Add(Exp(Mul(Const(-1.0), Mul(SqD(), "
                                  "Positive(0.8)))), Mul(Const(0.01), "
                                  "White(1.0, False)))"),
                     pair_terms=(jpk.PairTerm(**PAIR_TERMS[0]),))
    systems = [make_system(10 + k) for k in range(3)]
    model = JaxModel(jeng)
    for k, s in enumerate(systems):
        s.calc = JaxLJ(epsilon=0.15, sigma=2.3, rc=RC)
        for i in (0, 1, 5):
            model.add_inducing(env_of(s, i, JaxEnv), remake=False)
    for s in systems:
        model.add_data(JaxRecord.from_system(s), remake=False)
    model.make_munu()
    return model, systems


@pytest.fixture(scope="module")
def ks_folder(tmp_path_factory):
    from autoforce_tpu.io.model_io import save_model as jax_save

    path = str(tmp_path_factory.mktemp("ks") / "model.pckl")
    jax_save(kernel_space_model()[0], path)
    return path


@pytest.mark.parametrize("driver", ["md", "fire", "fire_cell"])
def test_drivers_pass_the_kernel_space(ks_folder, driver):
    """DeviceMD, DeviceFIRE and the variable cell (the NPT force/virial
    function) on a model with the whole kernel space, against the JAX
    package's drivers on the same model folder."""
    from autoforce_tpu import units
    from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
    from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
    from autoforce_tpu.opt.device_fire import DeviceFIRE as JaxDeviceFIRE
    from autoforce_tpu.system import maxwell_boltzmann_velocities
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.md.device_md import DeviceMD
    from autoforce_tpu_torch.opt.device_fire import DeviceFIRE
    from test_torch_active import port_system

    s0 = make_system(21, rattle=0.1)
    maxwell_boltzmann_velocities(s0, 300, seed=3)
    out = {}
    for pkg in ("jax", "torch"):
        kw = dict(covariance=ks_folder, calculator=None, logfile=None,
                  pckl=None, tape=None, skin=0.5)
        if pkg == "jax":
            calc, s = JaxCalc(**kw), s0.copy()
            MD, FIRE_ = JaxDeviceMD, JaxDeviceFIRE
        else:
            calc = ActiveCalculator(**kw, device="cpu", dtype=torch.float64)
            s, MD, FIRE_ = port_system(s0), DeviceMD, DeviceFIRE
        s.calc = calc
        if driver == "md":
            MD(s, calc, dt=2 * units.fs, chunk=7, thermostat="none").run(20)
        else:
            FIRE_(s, calc, dt=0.05, chunk=6, check_beta=False,
                  cell=driver == "fire_cell").run(fmax=1e-9, steps=15)
        out[pkg] = s
    np.testing.assert_allclose(out["torch"].positions, out["jax"].positions,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out["torch"].cell),
                               np.asarray(out["jax"].cell), rtol=0, atol=1e-10)


def test_band_forces_with_the_kernel_space(ks_folder):
    """The NEB's stacked band on the kernel-space model equals each image
    predicted alone."""
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.opt.device_neb import band_forces, stack_images
    from test_torch_active import port_system

    model = load_model(ks_folder, device="cpu", dtype=torch.float64)
    eng = model.engine
    imgs = [port_system(make_system(30 + k)) for k in range(3)]
    cfgs = [eng.make_config(s, npad=32, kpad=48) for s in imgs]
    ma = model.full_model_arrays()
    vs = torch.ones(32 * 3, dtype=torch.float64)
    pos = torch.stack([c.positions for c in cfgs])
    e, f, b = band_forces(pos, stack_images(cfgs), ma, eng.radii_table(), vs,
                          eng.params, 4, True, eng.kernel_space())
    for r, cfg in enumerate(cfgs):
        e1, f1, _, _, b1 = eng.predict(cfg, ma, np.ones(32))
        close(e[r], e1, atol=1e-10)
        close(f[r], f1, atol=1e-10)
        close(b[r], b1.max(), atol=1e-10)


def test_host_beta_equals_device_beta_with_pair_terms(ks_folder):
    """The sampling loop's host β normalizes by the device's k(x, x), the
    pair terms' share included: both β agree on the kernel-space model."""
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from test_torch_active import port_system

    calc = ActiveCalculator(covariance=ks_folder, calculator=None,
                            logfile=None, pckl=None, tape=None, device="cpu",
                            dtype=torch.float64)
    s = port_system(make_system(40, rattle=0.1))
    s.calc = calc
    calc.calculate(s)
    host = calc._host_beta()
    ma = calc.model.full_model_arrays()
    vs = calc.model.vscale_for(calc._padded_numbers())
    dev = calc.engine.predict(calc.cfg, ma, vs)[4][: len(s)]
    assert np.abs(calc._pair_alpha).max() > 1e-3
    close(host, dev, atol=1e-10)


def test_fvqr_projection_rejects_an_overflowed_residual():
    """A column projected through a near-singular fv-QR factor overflows
    its residual; the projection reports degeneracy (the cache drops and
    the exact path rebuilds) instead of writing inf into R."""
    from autoforce_tpu_torch.regression.sgpr import SgprModel

    _, teng = engines("dot")
    model = SgprModel(teng)
    rng = np.random.default_rng(0)
    K = rng.normal(size=(12, 2))
    model._fvqr = dict(R=np.diag([1.0, 1e-300]), z=np.zeros(2),
                       y=rng.normal(size=12), chain=0)
    assert model._fvqr_project_on(K, rng.normal(size=12)) is None
    model._fvqr["R"] = np.linalg.qr(K)[1]
    r, rho, zeta = model._fvqr_project_on(K, rng.normal(size=12))
    assert np.isfinite(r).all() and np.isfinite(rho) and rho > 0


@pytest.mark.parametrize("kind", ["rbf", "logrbf"])
@pytest.mark.parametrize("factor, n, eta", [(None, 2, 1), ("polycut", 2, 1),
                                            ("polycut", 3, 1),
                                            ("repulsive", 2, 2)])
def test_pair_factor_grads_match_forward_mode(kind, factor, n, eta):
    """The pair term's closed-form psi'(d) and fac'(d) (the backward of the
    pair Gram) against forward-mode AD of ``_psi`` / ``_factor``, on
    distances past both clamps and the cutoff; and the same values from
    four threads at once (on a mesh of several cards autograd runs one
    backward thread per card)."""
    import threading

    term = tpk.PairTerm(a=3, b=16, kind=kind, factor=factor, rc=4.0,
                        factor_n=n, eta=eta)
    d = torch.cat([torch.linspace(1e-13, 7.0, 4001, dtype=torch.float64),
                   torch.tensor([0.0, 1e-12, 5e-7, 1e-6, 4.0],
                                dtype=torch.float64)])
    one = torch.ones_like(d)
    _, p0 = torch.func.jvp(lambda x: tpk._psi(x, term), (d,), (one,))
    _, f0 = torch.func.jvp(lambda x: tpk._factor(x, term), (d,), (one,))
    p1, f1 = tpk.psi_factor_grads(d, term)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), rtol=1e-14, atol=0)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=1e-14,
                               atol=1e-14 * f0.abs().max().item())
    out = [None] * 4

    def run(k):
        out[k] = tpk.psi_factor_grads(d, term)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for p, f in out:
        assert torch.equal(p, p1) and torch.equal(f, f1)
