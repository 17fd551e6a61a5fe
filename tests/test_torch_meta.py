"""Metadynamics on the port against the JAX package (CPU, float64): the
ActiveMeta bias fused into ``DeviceMD`` (single model and committee), the
refusals of what the device drivers cannot integrate, ``meta_covloss_fn``,
the Steinhardt Q_l, the KDE and ``Meta(Posvar)`` / ``SoapMeta`` under the
host Langevin driver.

Both packages serve one model learned by the JAX package: the 32-atom Cu
model of tests/test_torch_npt.py, and for the committee the JAX package's
committee of tests/test_torch_bcm.py, restarted from its folders by both.

Tolerances: 1e-9 A for device trajectories against the host drivers and
the JAX device drivers (JAX's own test holds the fused bias to 1e-7 A
against its host driver); 1e-10 eV and eV/A for the bias energy and its
gradient between the packages; the committee floor against the host
betas as the JAX test holds it (rtol 1e-3, atol 2e-5: the fused bias
clips 1 - c at 1e-12, the host trigger at 0); 1e-8 relative for Q_l
against scipy's spherical harmonics (the JAX test's) and 1e-10 against
the JAX Q_l; host metadynamics runs to 1e-8 in energies, forces and
positions between the packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.meta import ActiveMeta as JaxActiveMeta
from autoforce_tpu.calculator.meta import Meta as JaxMeta
from autoforce_tpu.calculator.meta import Posvar as JaxPosvar
from autoforce_tpu.calculator.meta import SoapMeta as JaxSoapMeta
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.descriptor.ql import steinhardt_ql as jax_ql
from autoforce_tpu.engine import meta_covloss_fn as jax_meta_covloss_fn
from autoforce_tpu.md import Langevin as JaxLangevin
from autoforce_tpu.md import VelocityVerlet as JaxVerlet
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.md.device_md import _committee_e as jax_committee_e
from autoforce_tpu.md.device_md import committee_models as jax_models
from autoforce_tpu.md.device_md import committee_stack as jax_stack
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch import units
from autoforce_tpu_torch.analysis.kde import GaussianKDE
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.meta import (ActiveMeta, Catvar, Meta,
                                                 Posvar, Qlvar, SoapMeta)
from autoforce_tpu_torch.calculator.multitask import MultiTaskCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.descriptor.ql import steinhardt_ql
from autoforce_tpu_torch.engine import meta_covloss_fn
from autoforce_tpu_torch.md import Langevin, VelocityVerlet
from autoforce_tpu_torch.md import device_md as dmd
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.md.device_npt import DeviceNPT
from autoforce_tpu_torch.md.replica_md import ReplicaMD
from autoforce_tpu_torch.opt.device_fire import DeviceFIRE
from autoforce_tpu_torch.opt.device_neb import DeviceNEB
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_torch_bcm import JAX, PORT, inside, restart, train
from test_torch_npt import calc_pair, system_pair, trained_folder  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
FS = units.fs
SCALE = 0.05


def nve_pair(folder, meta_cls, steps=8, chunk=3):
    """(JAX device, port device, port host, port host without the bias)
    positions after ``steps`` NVE steps of 1 fs from one rattled,
    thermalized 32-atom box, ActiveMeta(scale=SCALE) on each."""
    out = []
    for name, device, bias in (("jax", True, True), ("port", True, True),
                               ("port", False, True), ("port", False, False)):
        jc, pc = calc_pair(folder)
        calc = jc if name == "jax" else pc
        if bias:
            calc.meta = (JaxActiveMeta if name == "jax" else meta_cls)(
                scale=SCALE)
        s = system_pair()[0 if name == "jax" else 1]
        s.calc = calc
        if device:
            kw = dict(device_rebuild=False) if name == "jax" else {}
            dyn = (JaxDeviceMD if name == "jax" else DeviceMD)(
                s, calc, dt=1 * FS, chunk=chunk, check_beta=False,
                thermostat="none", **kw)
            assert dyn.meta_scale == SCALE
            dyn.run(steps)
        else:
            VelocityVerlet(s, 1 * FS).run(steps)
        out.append(s.positions.copy())
    return out


def test_device_md_active_meta_matches_host(trained_folder):  # noqa: F811
    """The bias fused into the device step equals the host driver applying
    meta_covloss_fn every step, and the JAX package's fused step."""
    jdev, dev, host, plain = nve_pair(trained_folder, ActiveMeta)
    np.testing.assert_allclose(dev, host, atol=1e-9)
    np.testing.assert_allclose(dev, jdev, atol=1e-9)
    # the bias bends the trajectory
    assert np.abs(plain - host).max() > 1e-6


def test_meta_covloss_fn_matches_jax(trained_folder):  # noqa: F811
    """The bias energy and its gradient on a box rattled far enough that
    beta is well above its clip floor."""
    jc, pc = calc_pair(trained_folder)
    js, ps = system_pair(rattle=0.2, temperature=0)
    jc.calculate(js)
    pc.calculate(ps)
    jvs = jc.model.vscale_for(np.asarray(jc.cfg.numbers))
    je, jg = jax_meta_covloss_fn(
        jc.cfg, jc.model.full_model_arrays(), jc.engine.radii_table(),
        jnp.asarray(jvs), jc.engine.params, jc.engine.exponent, SCALE)
    pvs = pc.model.vscale_for(pc.cfg.numbers.numpy())
    pe, pg = meta_covloss_fn(pc.cfg, pc.model.full_model_arrays(),
                             pc.engine.radii_table(), torch.as_tensor(pvs),
                             pc.engine.params, pc.engine.exponent, SCALE)
    assert float(je) < -1e-4
    np.testing.assert_allclose(float(pe), float(je), rtol=0, atol=1e-10)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=1e-10)


class _FakeMeta:
    def __call__(self, c):
        return None


@pytest.mark.parametrize("what", ["meta", "restraints", "weights_sample",
                                  "weights_fin"])
def test_device_md_refuses_meta_and_multitask(trained_folder, what):  # noqa: F811
    """A bias or a multi-task schedule acts in the host calculate; the
    device drivers refuse what they would drop (a static multi-task
    surface and ActiveMeta under DeviceMD are served)."""
    _, calc = calc_pair(trained_folder)
    s = system_pair()[1]
    if what == "meta":
        calc.meta = _FakeMeta()
        for drv in (DeviceMD, ReplicaMD):
            with pytest.raises(NotImplementedError, match="metadynamics"):
                drv(s if drv is DeviceMD else [s], calc, dt=1 * FS,
                    check_beta=False)
        # DeviceNPT, DeviceFIRE and DeviceNEB refuse even ActiveMeta
        calc.meta = ActiveMeta()
        with pytest.raises(NotImplementedError, match="metadynamics"):
            DeviceNPT(s, calc, 1 * FS, temperature_K=300, check_beta=False)
        with pytest.raises(NotImplementedError, match="metadynamics"):
            DeviceFIRE(s, calc, check_beta=False)
        with pytest.raises(NotImplementedError, match="metadynamics"):
            DeviceNEB([s, s.copy(), s.copy()], calc, check_beta=False)
        return
    kw = {"restraints": dict(ij=[(0, 1)]),
          "weights_sample": dict(weights_sample=100),
          "weights_fin": dict(weights_fin=[0.0, 1.0])}[what]
    mt = MultiTaskCalculator(
        [LennardJones(rc=4.0), LennardJones(epsilon=0.2, rc=4.0)],
        kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2), logfile=None, pckl=None,
        tape=None, **kw, **F64)
    with pytest.raises(NotImplementedError, match="multi-task"):
        DeviceMD(s, mt, dt=1 * FS, check_beta=False)


@pytest.fixture(scope="module")
def jax_committee(tmp_path_factory):
    """The JAX package's learned committee (tests/test_torch_bcm.py) in a
    folder both packages restart from."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    folder = str(tmp_path_factory.mktemp("bcm"))
    try:
        with inside(folder):
            _, s = train(JAX)
    finally:
        torch.set_num_threads(threads)
    return folder, s.positions.copy()


def test_committee_meta_bias_is_floor_formula(jax_committee):
    """The fused committee bias equals -scale * sum_i min_k beta_ki from
    each expert's host covloss, and the JAX package's fused bias."""
    folder, pos = jax_committee
    jc, pc = restart(JAX, folder), restart(PORT, folder)
    rng = np.random.default_rng(33)
    s_j = jax_bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s_j.set_positions(pos + rng.normal(0, 0.15, pos.shape))
    s_p = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s_p.set_positions(s_j.positions)
    jc.calculate(s_j)
    pc.calculate(s_p)

    # the port's fused bias
    chain = dmd.new_chain(pc, s_p, False, meta=True)
    cfg, eng = chain["cfg"], pc.engine
    args = (cfg.cell, cfg, chain["ma"], chain["radii"], chain["vs"],
            chain["mean_e"], eng.params, eng.exponent, chain["ks"])
    e_plain = float(dmd._committee_e(cfg.positions, *args)[0][0])
    with torch.enable_grad():
        p = cfg.positions.clone().requires_grad_(True)
        e_meta = dmd._committee_e(p, *args[:-1], chain["ks"],
                                  meta_scale=SCALE,
                                  meta_vs=chain["meta_vs"])[0][0]
        (g,) = torch.autograd.grad(e_meta, p)
    e_meta = float(e_meta.detach())
    assert np.isfinite(g.numpy()).all()

    # the host floor from each expert's own covloss
    betas = []
    for m in dmd.committee_models(pc):
        ac = ActiveCalculator(covariance=m, calculator=None, logfile=None,
                              pckl=None, tape=None)
        ac.calculate(s_p.copy())
        betas.append(ac._host_beta())
    expected = -SCALE * np.stack(betas).min(axis=0).sum()
    assert expected < -1e-4
    np.testing.assert_allclose(float(e_meta) - e_plain, expected, rtol=1e-3,
                               atol=2e-5)

    # the JAX package's fused bias on the same committee
    models = jax_models(jc)
    ma, vs_c, mean_e = jax_stack(jc, s_j, models, jc.cfg,
                                 {"mcap": 0, "cache": {}})
    meta_vs = np.where(vs_c >= JaxDeviceMD._VS_UNSEEN, 0.0, vs_c)
    je = jc.engine
    chem_z, mixL = je.chem_args()

    def jax_e(mscale=None, mvs=None):
        return float(jax_committee_e(
            jc.cfg.positions, jc.cfg.cell, jc.cfg, ma, je.radii_table(),
            je.znum_table(), jnp.asarray(vs_c), jnp.asarray(mean_e),
            je.params, je.exponent, je.pair_terms, chem_z, mixL,
            je.kernel_kind, meta_scale=mscale, meta_vs=mvs)[0])

    np.testing.assert_allclose(
        float(e_meta) - e_plain,
        jax_e(jnp.asarray(SCALE), jnp.asarray(meta_vs)) - jax_e(),
        rtol=0, atol=1e-10)


def test_committee_of_identical_experts_matches_single_model(jax_committee):
    """Two identical experts and the fused bias reproduce the single
    model's fused-bias trajectory (the floor is that model's beta, the
    weights 1/2 over one surface), and the bias bends the trajectory."""
    folder, pos = jax_committee
    pc = restart(PORT, folder)
    model = next(iter(pc.experts.values()))
    single = ActiveCalculator(covariance=model, calculator=None,
                              logfile=None, pckl=None, tape=None)

    def run(c, bias=True):
        c.meta = ActiveMeta(scale=SCALE) if bias else None
        s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
        s.set_positions(pos)
        maxwell_boltzmann_velocities(s, 300, seed=9)
        s.calc = c
        DeviceMD(s, c, dt=2 * FS, chunk=3, check_beta=False,
                 thermostat="none").run(8)
        c.meta = None
        return s.positions.copy()

    # the same model as the one frozen expert and as the live model
    pc.experts = {"e1": model}
    pc.model = model
    assert len(dmd.committee_models(pc)) == 2
    pos_committee = run(pc)
    np.testing.assert_allclose(pos_committee, run(single), atol=1e-9)
    assert np.abs(run(pc, bias=False) - pos_committee).max() > 1e-6


def test_ql_vs_scipy_and_jax():
    from scipy.special import sph_harm_y

    rng = np.random.default_rng(0)
    xyz = rng.uniform(0.5, 1.5, (5, 3))
    lmax, rc = 6, 6.0
    q1 = steinhardt_ql(torch.as_tensor(xyz), lmax, rc).numpy()
    np.testing.assert_allclose(q1, np.asarray(jax_ql(jnp.asarray(xyz), lmax,
                                                     rc)), rtol=1e-10)
    r = np.linalg.norm(xyz, axis=1)
    theta = np.arccos(xyz[:, 2] / r)
    phi = np.arctan2(xyz[:, 1], xyz[:, 0])
    cut = (1 - r / rc) ** 2
    for l in range(lmax + 1):
        s = 0.0
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, abs(m), theta, phi)
            if m < 0:
                ylm = (-1) ** m * np.conj(ylm)
            s += abs((ylm * cut).sum() / cut.sum()) ** 2
        np.testing.assert_allclose(q1[l], np.sqrt(4 * np.pi / (2 * l + 1) * s),
                                   rtol=1e-8)


def test_kde():
    kde = GaussianKDE(0.1)
    rng = np.random.default_rng(1)
    for x in rng.normal(0.0, 0.5, 200):
        kde.count(np.array([x]))
    assert kde.total == 200
    assert kde(np.array([0.0]), density=True) > kde(np.array([2.0]),
                                                    density=True)
    pts, w = kde.histogram()
    assert w.sum() == 200


def meta_run(name, tmp, bias, steps=10):
    """Host Langevin learning from Lennard-Jones Cu with a bias attached
    (JAX's test_meta_md), in ``tmp``; returns (calc, system, bias)."""
    with inside(tmp):
        if name == "jax":
            meta = (JaxMeta(JaxPosvar(0), sigma=0.2, w=0.05) if bias == "posvar"
                    else JaxSoapMeta(scale=1e-2))
            calc = JaxCalc(covariance=None, calculator=JaxLJ(
                epsilon=0.15, sigma=2.3, rc=4.0), logfile="active.log",
                pckl=None, tape=None, ediff=0.05, fdiff=0.1, ioptim=10**6,
                kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2), seed=0)
            s = jax_bulk_fcc("Cu", 3.6)
            mb, Lang = jax_mb, JaxLangevin
        else:
            meta = (Meta(Posvar(0), sigma=0.2, w=0.05) if bias == "posvar"
                    else SoapMeta(scale=1e-2))
            calc = ActiveCalculator(covariance=None, calculator=LennardJones(
                epsilon=0.15, sigma=2.3, rc=4.0), logfile="active.log",
                pckl=None, tape=None, ediff=0.05, fdiff=0.1, ioptim=10**6,
                kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2), seed=0, **F64)
            s = bulk_fcc("Cu", 3.6)
            mb, Lang = maxwell_boltzmann_velocities, Langevin
        calc.meta = meta
        s.rattle(0.03, seed=0)
        s.calc = calc
        mb(s, 200, seed=1)
        dyn = Lang(s, 2 * FS, 200, friction=0.02, seed=2)
        dyn.attach(meta.update)
        dyn.run(steps)
    return calc, s, meta


@pytest.mark.parametrize("bias", ["posvar", "soap"])
def test_meta_md_matches_jax(tmp_path, bias):
    """Meta(Posvar) and SoapMeta under the host Langevin driver, learning
    on the fly, in both packages: the same KDE, log and trajectory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for name in ("jax", "port"):
            tmp = tmp_path / name
            tmp.mkdir()
            runs[name] = meta_run(name, str(tmp), bias) + (str(tmp),)
    finally:
        torch.set_num_threads(threads)
    (jc, js, jm, jt), (pc, ps, pm, pt) = runs["jax"], runs["port"]
    assert pc.size == jc.size
    np.testing.assert_allclose(ps.positions, js.positions, rtol=0, atol=1e-8)
    np.testing.assert_allclose(pc.results["forces"], jc.results["forces"],
                               rtol=0, atol=1e-8)
    assert abs(pc.results["energy"] - jc.results["energy"]) < 1e-8
    assert np.isfinite(ps.get_forces()).all()
    lines = [line for line in open(os.path.join(pt, "active.log"))
             if "meta:" in line]
    assert len(lines) >= 10
    if bias == "posvar":
        assert pm.kde.total == jm.kde.total >= 10
        assert os.path.isfile(os.path.join(pt, "meta.hist"))
        assert pm.kde.data == jm.kde.data
    else:
        np.testing.assert_allclose(pm.pot, jm.pot, rtol=0, atol=1e-10)


class _Host:
    """What Meta reads of a calculator: the system, its neighbor table and
    the engine's device."""

    def __init__(self, system, nl):
        self.system = system
        self._nl = nl
        self.engine = type("E", (), {"device": torch.device("cpu")})


def test_qlvar_and_catvar_bias():
    """Meta on Catvar(Posvar, Qlvar): the bias forces are the negative
    gradient of the bias energy (central differences, 1e-6 relative)."""
    from autoforce_tpu_torch.neighbors import neighbor_table

    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.1, seed=3)
    nl = neighbor_table(s.positions, s.cell, s.pbc, 4.0)
    meta = Meta(Catvar(Posvar(0), Qlvar(29, 29, cutoff=4.0, l=(4, 6))),
                sigma=0.05, w=0.5, hist=None)
    meta(_Host(s, nl))  # no deposit yet: the bias is 0
    meta.update()
    meta.update()
    cv = meta._cv
    me = meta(_Host(s, nl))
    assert me["energy"] > 0
    assert np.abs(me["forces"]).max() > 0
    h = 1e-5
    for a, k in ((0, 0), (1, 2), (5, 1)):
        e = []
        for sign in (1, -1):
            t = s.copy()
            p = t.positions.copy()
            p[a, k] += sign * h
            t.set_positions(p)
            meta._cv = cv  # the same deposits in reach
            e.append(meta(_Host(t, nl))["energy"])
        np.testing.assert_allclose(me["forces"][a, k],
                                   -(e[0] - e[1]) / (2 * h), rtol=1e-6,
                                   atol=1e-9)
