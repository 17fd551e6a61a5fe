"""Bayesian committees (BCM) on the port against the JAX package (CPU,
float64): ``BCMActiveCalculator`` (spawn, restart, the weighted
combination), ``committee_stack``'s staging cache, and the committee
served by ``DeviceMD``, ``DeviceNPT``, ``DeviceFIRE`` and ``DeviceNEB``.

The committee is learned as the JAX package's own BCM tests learn it
(tests/test_bcm_multitask.py ``_trained_bcm``: Lennard-Jones Cu, lmax =
nmax = 2, rc = 4 A, ``max_inducing=6``, ``max_data=2``, seeded), on the
32-atom box and with the noise optimizer off (``ioptim``), so that both
packages take the same sampling decisions (test_torch_active.py says
why).  The drivers are held on the JAX package's committee, restarted
from its expert folders by both packages, so both serve the same models.

Tolerances: 1e-8 for committee energies and forces between the packages;
1e-9 A for device trajectories against the port's host drivers and
against the JAX device drivers (the JAX tests' 1e-8 A and 1e-10 A for the
NPT positions and cells against the host MTK step), 1e-12 relative for
the FIRE clock.
"""

import contextlib
import os
import re
import shutil

import numpy as np
import pytest
import torch

from autoforce_tpu import units
from autoforce_tpu.calculator.bcm import BCMActiveCalculator as JaxBCM
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.md import MTKNPT as JaxMTKNPT
from autoforce_tpu.md import Langevin as JaxLangevin
from autoforce_tpu.md import VelocityVerlet as JaxVerlet
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.md.device_npt import DeviceNPT as JaxDeviceNPT
from autoforce_tpu.opt import FIRE as JaxFIRE
from autoforce_tpu.opt import NEB as JaxNEB
from autoforce_tpu.opt import UnitCellFilter as JaxUnitCellFilter
from autoforce_tpu.opt.device_fire import DeviceFIRE as JaxDeviceFIRE
from autoforce_tpu.opt.device_neb import DeviceNEB as JaxDeviceNEB
from autoforce_tpu.opt.neb import interpolate_images as jax_interpolate
from autoforce_tpu.pairkernels import PairTerm as JaxPairTerm
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch.calculator import BCMActiveCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.md import MTKNPT, Langevin, VelocityVerlet
from autoforce_tpu_torch.md import device_md as dmd
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.md.device_npt import DeviceNPT, _sgpr_forces_virial
from autoforce_tpu_torch.opt import FIRE, NEB, UnitCellFilter
from autoforce_tpu_torch.opt.device_fire import DeviceFIRE
from autoforce_tpu_torch.opt.device_neb import DeviceNEB, band_forces
from autoforce_tpu_torch.opt.neb import interpolate_images
from autoforce_tpu_torch.pairkernels import PairTerm
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

JAX = dict(BCM=JaxBCM, LJ=JaxLJ, fcc=jax_bulk_fcc, mb=jax_mb,
           Langevin=JaxLangevin, Verlet=JaxVerlet, MTKNPT=JaxMTKNPT,
           FIRE=JaxFIRE, NEB=JaxNEB, UnitCellFilter=JaxUnitCellFilter,
           DeviceMD=JaxDeviceMD, DeviceNPT=JaxDeviceNPT,
           DeviceFIRE=JaxDeviceFIRE, DeviceNEB=JaxDeviceNEB,
           interpolate=jax_interpolate, PairTerm=JaxPairTerm, kw={})
PORT = dict(BCM=BCMActiveCalculator, LJ=LennardJones, fcc=bulk_fcc,
            mb=maxwell_boltzmann_velocities, Langevin=Langevin,
            Verlet=VelocityVerlet, MTKNPT=MTKNPT, FIRE=FIRE, NEB=NEB,
            UnitCellFilter=UnitCellFilter, DeviceMD=DeviceMD,
            DeviceNPT=DeviceNPT, DeviceFIRE=DeviceFIRE, DeviceNEB=DeviceNEB,
            interpolate=interpolate_images, PairTerm=PairTerm,
            kw=dict(device="cpu", dtype=torch.float64))
KERNEL = dict(cutoff=4.0, lmax=2, nmax=2)
LEARN = dict(kernel_kw=KERNEL, ediff=0.002, ediff_tot=0.01, fdiff=0.02,
             noise_f=0.005, max_data=2, max_inducing=6, eps_dr=0.0, seed=5,
             ioptim=10**6)
FS = units.fs


@contextlib.contextmanager
def inside(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def train(pkg, pair=False, **kw):
    """A committee learned from Lennard-Jones Cu under host Langevin MD
    (in the working directory) until it has ``nexp`` experts."""
    nexp = kw.pop("nexp", 2)
    calc = pkg["BCM"](calculator=pkg["LJ"](epsilon=0.15, sigma=2.3, rc=4.0),
                      pckl="bcm.pckl", logfile="active.log",
                      **{**LEARN, **kw}, **pkg["kw"])
    if pair:
        calc.engine.pair_terms = (pkg["PairTerm"](a=29, b=29, rc=4.0),)
    s = pkg["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=0)
    s.calc = calc
    pkg["mb"](s, 500, seed=1)
    dyn = pkg["Langevin"](s, 2 * FS, 500, friction=0.02, seed=2)
    k = 0
    while len(calc.experts) < nexp and k < 60:
        dyn.run(5)
        k += 1
    assert len(calc.experts) >= nexp, (len(calc.experts), calc.size)
    return calc, s


def restart(pkg, folder, oracle=False, **kw):
    """A committee found again from the expert folders ``folder/bcm_k``."""
    lj = pkg["LJ"](epsilon=0.15, sigma=2.3, rc=4.0) if oracle else None
    kw = {**(LEARN if oracle else dict(kernel_kw=KERNEL)), **kw}
    return pkg["BCM"](calculator=lj, pckl=os.path.join(folder, "bcm.pckl"),
                      logfile=None, **kw, **pkg["kw"])


def froze(path):
    return [re.sub(r"^\S+ \S+ \S+ ", "", line).strip()
            for line in open(path) if "BCM: froze" in line]


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    """The committee learned by each package (its folder, calculator and
    last snapshot); single-thread sums, as the decisions are threshold
    tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, pkg in (("jax", JAX), ("port", PORT)):
            folder = str(tmp_path_factory.mktemp(name))
            with inside(folder):
                calc, s = train(pkg)
            out[name] = (folder, calc, s)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def pair_learned(tmp_path_factory):
    """The JAX package's committee with a Cu-Cu pair term, at least three
    experts (its test_bcm_many_experts_restart_and_config)."""
    folder = str(tmp_path_factory.mktemp("pair"))
    with inside(folder):
        train(JAX, pair=True, nexp=3, ediff=0.001, ediff_tot=0.005,
              fdiff=0.01, noise_f=0.003, max_data=1, max_inducing=3)
    return folder


def committees(folder, **kw):
    """The committee of ``folder`` in both packages, serving."""
    return restart(JAX, folder, **kw), restart(PORT, folder, **kw)


def system(pkg, like):
    s = pkg["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    s.set_positions(like.positions)
    return s


def test_bcm_spawns_and_predicts(learned):
    (jdir, jcalc, js), (pdir, pcalc, ps) = learned["jax"], learned["port"]
    # the same experts, frozen at the same sizes, in the same folders
    assert [m.size for m in pcalc.experts.values()] == [
        m.size for m in jcalc.experts.values()]
    assert pcalc.size == jcalc.size and len(pcalc.experts) >= 2
    assert froze(os.path.join(pdir, "active.log")) == froze(
        os.path.join(jdir, "active.log"))
    assert sorted(f for f in os.listdir(pdir) if f.endswith(".pckl")) == \
        sorted(f for f in os.listdir(jdir) if f.endswith(".pckl"))
    np.testing.assert_allclose(ps.positions, js.positions, atol=1e-9)
    # each package's committee, found again from its folders
    res = {}
    for name, pkg, folder in (("jax", JAX, jdir), ("port", PORT, pdir),
                              ("port_on_jax", PORT, jdir)):
        c = restart(pkg, folder)
        assert len(c.experts) == len(jcalc.experts) - 1  # last one is live
        r = c.calculate(system(pkg, js))
        res[name] = (r["energy"], r["forces"], r["stress"])
    for name in ("port", "port_on_jax"):
        np.testing.assert_allclose(res[name][0], res["jax"][0], atol=1e-8)
        np.testing.assert_allclose(res[name][1], res["jax"][1], atol=1e-8)
        np.testing.assert_allclose(res[name][2], res["jax"][2], atol=1e-8)
    assert np.isfinite(res["port"][1]).all()


def weighted_average(calc, s):
    """The committee's prediction written out: -log(c)/c weights."""
    models = [m for m in [*calc.experts.values(), calc.model]
              if m.m > 0 and len(m.mu) == m.m]
    parts = []
    for m in models:
        e, f, w, cov, beta = (np.asarray(x) for x in calc._expert_dispatch(m))
        c = min(max(float(beta[: len(s)].max()), 1e-12), 1.0)
        sc = (-np.log(c) if c < 1.0 else 0.0) / c
        parts.append((sc, float(e) + m.mean_energy(s.numbers), f[: len(s)]))
    den = sum(p[0] for p in parts)
    if den <= 0:  # every covmax saturated: equal weights
        parts = [(1.0, e, f) for _, e, f in parts]
        den = len(parts)
    return (sum(w * e for w, e, _ in parts) / den,
            sum(w * f for w, _, f in parts) / den)


def test_bcm_many_experts_restart_and_config(pair_learned, tmp_path):
    # the port's own learning: three experts, the pair term kept
    with inside(str(tmp_path)):
        calc, s = train(PORT, pair=True, nexp=3, ediff=0.001,
                        ediff_tot=0.005, fdiff=0.01, noise_f=0.003,
                        max_data=1, max_inducing=3)
    assert calc.engine.pair_terms == (PairTerm(a=29, b=29, rc=4.0),)
    assert all(m.engine.pair_terms == calc.engine.pair_terms
               for m in calc.experts.values())
    calc._calc = None  # serving: nothing is learned or saved from here
    res = calc.calculate(s.copy())
    e, f = weighted_average(calc, s)
    np.testing.assert_allclose(res["energy"], e, rtol=1e-8)
    np.testing.assert_allclose(res["forces"], f, atol=1e-8)
    # the JAX package's three-expert committee in both packages
    jc, pc = committees(pair_learned)
    assert len(pc.experts) == len(jc.experts) >= 2
    assert pc.engine.pair_terms == (PairTerm(a=29, b=29, rc=4.0),)
    js = JAX["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    js.rattle(0.05, seed=7)
    rj = jc.calculate(js)
    rp = pc.calculate(system(PORT, js))
    np.testing.assert_allclose(rp["energy"], rj["energy"], atol=1e-8)
    np.testing.assert_allclose(rp["forces"], rj["forces"], atol=1e-8)
    e, f = weighted_average(pc, js)
    np.testing.assert_allclose(rp["energy"], e, rtol=1e-8)
    np.testing.assert_allclose(rp["forces"], f, atol=1e-8)


def test_committee_stack_caches_frozen_experts(learned):
    folder, _, js = learned["jax"]
    jc, pc = committees(folder)
    s = system(PORT, js)
    pc.calculate(s)
    models = dmd.committee_models(pc)
    assert len(models) >= 2
    state = {}
    ma, vs, mean_e = dmd.committee_stack(pc, s, models, pc.cfg, state)
    first = {k: ent[2][0] for k, ent in state["cache"].items()}
    # no state change: every expert's staging is reused as it is
    dmd.committee_stack(pc, s, models, pc.cfg, state)
    for k, ent in state["cache"].items():
        assert ent[2][0] is first[k]
    # the JAX package stacks the same arrays
    jsys = system(JAX, js)
    jc.calculate(jsys)
    jdyn = JaxDeviceMD(jsys, jc, dt=2 * FS, device_rebuild=False)
    jma, jvs, jmean = jdyn._committee_stack(jdyn._committee_models(), jc.cfg)
    np.testing.assert_allclose(ma.X_desc.numpy(), np.asarray(jma.X_desc),
                               atol=1e-12)
    np.testing.assert_array_equal(ma.m_mask.numpy(), np.asarray(jma.m_mask))
    np.testing.assert_allclose(ma.mu.numpy(), np.asarray(jma.mu), rtol=1e-12)
    np.testing.assert_allclose(ma.choli.numpy(), np.asarray(jma.choli),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(vs, jvs, rtol=1e-12)
    np.testing.assert_allclose(mean_e, jmean, rtol=1e-12)
    # changing one model restages exactly that expert
    victim = models[0]
    v0 = victim.state_version
    victim._model_arrays = None
    assert victim.state_version == v0 + 1
    dmd.committee_stack(pc, s, models, pc.cfg, state)
    for k, ent in state["cache"].items():
        assert (ent[2][0] is first[k]) == (k != id(victim))


def nve(pkg, calc, like, steps, chunk, device, seed=9, temperature=300,
        **kw):
    """An NVE run from ``like``'s positions: host velocity Verlet, or the
    device driver in chunks."""
    s = system(pkg, like) if like is not None else kw.pop("s")
    pkg["mb"](s, temperature, seed=seed)
    s.calc = calc
    if device:
        extra = {} if pkg is PORT else dict(device_rebuild=False)
        dyn = pkg["DeviceMD"](s, calc, dt=2 * FS, chunk=chunk,
                              check_beta=False, thermostat="none",
                              **extra, **kw)
        dyn.run(steps)
        assert dyn.nsteps == steps
    else:
        calc.calculate(s)
        pkg["Verlet"](s, 2 * FS).run(steps)
    return s.positions.copy(), s.get_velocities().copy()


def test_bcm_device_md_matches_host_committee(learned):
    folder, _, js = learned["jax"]
    jc, pc = committees(folder)
    host = nve(PORT, pc, js, 8, 3, device=False)
    dev = nve(PORT, pc, js, 8, 3, device=True)
    jdev = nve(JAX, jc, js, 8, 3, device=True)
    for a, b in zip(dev, host):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(dev, jdev):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_bcm_device_md_committee_samples(learned, tmp_path):
    """Active committee MD on the device: the trip hands control to the
    committee calculator, which samples and spawns an expert as the JAX
    package's does (NVE, so that no random numbers differ; the restart
    leaves the live model room to grow before it is frozen)."""
    folder, _, js = learned["jax"]
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        work = str(tmp_path / name)
        shutil.copytree(folder, work)
        with inside(work):
            c = restart(pkg, work, oracle=True, ediff=0.003, max_inducing=12,
                        max_data=4)
            nexp0 = len(c.experts)
            s = system(pkg, js)
            pkg["mb"](s, 300, seed=4)
            s.calc = c
            extra = {} if pkg is PORT else dict(device_rebuild=False)
            dyn = pkg["DeviceMD"](s, c, dt=2 * FS, chunk=5,
                                  thermostat="none", **extra)
            assert dyn.check_beta
            dyn.run(40)
            assert dyn.nsteps >= 40 and np.isfinite(s.positions).all()
            assert len(c.experts) > nexp0
            out[name] = ([m.size for m in c.experts.values()], c.size,
                         s.positions.copy(), c.step)
            c._calc = None
            assert np.isfinite(c.calculate(s.copy())["energy"])
    assert out["port"][0] == out["jax"][0] and out["port"][1] == out["jax"][1]
    assert out["port"][3] == out["jax"][3] > 1  # the same host visits
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=1e-8)


def test_bcm_device_md_committee_pair_terms(pair_learned):
    jc, pc = committees(pair_learned)
    like = JAX["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    like.rattle(0.05, seed=3)
    host = nve(PORT, pc, like, 5, 2, device=False)
    dev = nve(PORT, pc, like, 5, 2, device=True)
    jdev = nve(JAX, jc, like, 5, 2, device=True)
    for a, b in zip(dev, host):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(dev, jdev):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_bcm_device_md_in_loop_rebuild(learned):
    """Committee chunks rebuild the neighbor table in the loop: the same
    trajectory as a run whose breaches go through the host, and as the
    JAX package's in-loop run (a 108-atom box, where the single-image
    device build holds, and a 0.1 A skin)."""
    folder, _, _ = learned["jax"]
    jc, pc = committees(folder, skin=0.10)
    out = {}
    for name, pkg, calc, inloop in (("host", PORT, pc, False),
                                    ("port", PORT, pc, True),
                                    ("jax", JAX, jc, True)):
        s = pkg["fcc"]("Cu", 3.6).repeat((3, 3, 3))
        s.rattle(0.05, seed=0)
        pkg["mb"](s, 400, seed=9)
        s.calc = calc
        dyn = pkg["DeviceMD"](s, calc, dt=2 * FS, chunk=15, check_beta=False,
                              thermostat="none")
        assert dyn.in_loop_rebuild  # the single-image build holds here
        dyn.in_loop_rebuild = inloop
        dyn.run(30)
        assert dyn.nsteps == 30
        out[name] = (s.positions.copy(), s.get_velocities().copy())
    for a, b in zip(out["port"], out["host"]):
        np.testing.assert_allclose(a, b, atol=1e-8)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_bcm_device_npt_matches_host(learned):
    folder, _, _ = learned["jax"]
    jc, pc = committees(folder)
    kw = dict(temperature_K=300, pressure_GPa=0.3, tdamp=50 * FS,
              pdamp=200 * FS)
    s0 = JAX["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    s0.rattle(0.04, seed=4)
    v0 = np.random.default_rng(5).normal(size=(len(s0), 3)) * 0.01
    out = {}
    for name, pkg, calc in (("host", PORT, pc), ("port", PORT, pc),
                            ("jax", JAX, jc)):
        s = system(pkg, s0)
        s.set_velocities(v0)
        s.calc = calc
        if name == "host":
            pkg["MTKNPT"](s, 2 * FS, isotropic=False, **kw).run(8)
        else:
            d = pkg["DeviceNPT"](s, calc, 2 * FS, chunk=4, check_beta=False,
                                 isotropic=False, **kw)
            d.run(8)
            assert d.nsteps == 8
        out[name] = (s.positions.copy(), np.asarray(s.cell).copy())
    np.testing.assert_allclose(out["port"][0], out["host"][0], atol=1e-8)
    np.testing.assert_allclose(out["port"][1], out["host"][1], atol=1e-10)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], atol=1e-9)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-10)
    # the committee virial moved the cell
    assert np.abs(out["port"][1] - np.asarray(s0.cell)).max() > 1e-6


@pytest.mark.parametrize("cell", [False, True])
def test_bcm_device_fire_matches_host(learned, cell):
    folder, _, _ = learned["jax"]
    jc, pc = committees(folder)
    s0 = JAX["fcc"]("Cu", 3.6).repeat((2, 2, 2))
    s0.rattle(0.10, seed=6)
    steps = 8 if cell else 10
    out = {}
    for name, pkg, calc in (("host", PORT, pc), ("port", PORT, pc),
                            ("jax", JAX, jc)):
        s = system(pkg, s0)
        s.calc = calc
        if name == "host":
            target = pkg["UnitCellFilter"](s) if cell else s
            opt = pkg["FIRE"](target, dt=0.05)
            for _ in range(steps):
                opt.step(target.get_forces())
                opt.nsteps += 1
            clock = opt.dt
        else:
            d = pkg["DeviceFIRE"](s, calc, dt=0.05, chunk=4,
                                  check_beta=False, cell=cell)
            d.run(fmax=1e-9, steps=steps)
            assert d.nsteps == steps
            clock = d.dt_cur
        out[name] = (s.positions.copy(), np.asarray(s.cell).copy(), clock)
    for ref, tol in (("host", 1e-9), ("jax", 1e-9)):
        np.testing.assert_allclose(out["port"][0], out[ref][0], atol=tol)
        np.testing.assert_allclose(out["port"][1], out[ref][1], atol=1e-10)
        np.testing.assert_allclose(out["port"][2], out[ref][2], rtol=1e-12)


def test_bcm_device_neb_matches_host_committee(learned):
    folder, _, _ = learned["jax"]
    jc, pc = committees(folder)

    def band(pkg, calc):
        ends = []
        for seed in (1, 2):
            s = pkg["fcc"]("Cu", 3.6).repeat((2, 2, 2))
            s.rattle(0.08, seed=seed)
            s.calc = calc
            ends.append(s)
        images = pkg["interpolate"](ends[0], ends[1], 5)
        for im in images:
            im.calc = calc
        return images

    out = {}
    for name, pkg, calc in (("host", PORT, pc), ("port", PORT, pc),
                            ("jax", JAX, jc)):
        images = band(pkg, calc)
        if name == "host":
            nb = pkg["NEB"](images, k=0.1)
            opt = pkg["FIRE"](nb, dt=0.05, maxstep=0.1)
            for _ in range(8):
                opt.step(nb.get_forces())
                opt.nsteps += 1
            clock = opt.dt
        else:
            d = pkg["DeviceNEB"](images, calc, k=0.1, dt=0.05, maxstep=0.1,
                                 chunk=4, check_beta=False)
            d.run(fmax=1e-9, steps=8)
            assert d.nsteps == 8
            clock = d.dt_cur
        out[name] = ([im.positions.copy() for im in images], clock)
    for ref in ("host", "jax"):
        for a, b in zip(out["port"][0], out[ref][0]):
            np.testing.assert_allclose(a, b, atol=1e-9)
        np.testing.assert_allclose(out["port"][1], out[ref][1], rtol=1e-12)
    assert len(pc.experts) >= 2


@pytest.mark.parametrize("path", ["md", "virial", "band"])
def test_committee_step_launches_each_kernel_once(learned, monkeypatch, path):
    """One committee evaluation of E >= 2 experts computes the descriptors
    once: one call of the coefficient forward and one of its backward
    (their plain versions here, on the CPU), whatever E is."""
    folder, _, js = learned["jax"]
    pc = restart(PORT, folder)
    s = system(PORT, js)
    pc.calculate(s)
    chain = dmd.new_chain(pc, s, check_beta=True)
    ma, vs, mean_e = chain["ma"], chain["vs"], chain["mean_e"]
    assert mean_e is not None and ma.X_desc.shape[0] >= 2
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "soap_coeff_fwd_plain"),
                      ("bwd", "soap_coeff_bwd_plain")):
        def counted(*a, _inner=getattr(sk, name), _key=key):
            calls[_key] += 1
            return _inner(*a)

        monkeypatch.setattr(sk, name, counted)
    cfg, eng = chain["cfg"], pc.engine
    args = (chain["radii"], vs, eng.params, eng.exponent, True)
    if path == "md":
        e, f, b = dmd._sgpr_forces(cfg.positions, cfg, ma, *args,
                                   chain["ks"], mean_e)
    elif path == "virial":
        e, f, _, b = _sgpr_forces_virial(cfg.positions, cfg.cell, cfg, ma,
                                         *args, aniso=True, ks=chain["ks"],
                                         mean_e=mean_e)
    else:
        from autoforce_tpu_torch.opt.device_neb import stack_images

        band_cfg = stack_images([cfg, cfg])
        pos = torch.stack([cfg.positions, cfg.positions])
        e, f, b = band_forces(pos, band_cfg, ma, chain["radii"],
                              vs.repeat(1, 2), eng.params, eng.exponent,
                              True, chain["ks"], mean_e)
        assert e.shape == (2,) and abs(float(e[0] - e[1])) < 1e-10
        e, b = e[0], b.max()
    assert calls == {"fwd": 1, "bwd": 1}
    # and the committee energy is the host combination's
    np.testing.assert_allclose(float(e), pc.results["energy"], atol=1e-8)
    np.testing.assert_allclose(
        f.reshape(-1, cfg.npad, 3)[0, : len(s)].numpy(),
        pc.results["forces"], atol=1e-8)
    assert np.isfinite(float(b))
