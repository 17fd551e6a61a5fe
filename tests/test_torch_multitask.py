"""Multi-task learning on the port against the JAX package (CPU, float64):
``MultiTaskCalculator`` learning two Lennard-Jones tasks under the host
Langevin driver, weight switches, weights-space sampling and the
thermodynamic-integration schedule, the QMMM bond restraints, the solve
state a rejected trial restores, and the static multi-task surface under
``DeviceMD``.

Each learning run goes through both packages from the same seeds with
single-thread sums (the sampling decisions are threshold tests,
tests/test_torch_active.py), lmax = nmax = 2, rc = 4 A, on the 4-atom Cu
cell of the JAX package's own tests (tests/test_bcm_multitask.py).

Tolerances: 1e-8 eV and eV/A for energies, task energies and forces
between the packages; 1e-7 relative for the multi-task weights mu_tasks
(~2e4 in size: the Kronecker least squares is ill-conditioned, and the
weights cancel to energies of a few eV);
1e-9 A and A/fs for device trajectories against the host driver and the
JAX device driver (the JAX test's 1e-9); 1e-8 for the restraint terms
(the JAX test's).
"""

import numpy as np
import pytest
import torch

from autoforce_tpu import units as jax_units
from autoforce_tpu.calculator.multitask import MultiTaskCalculator as JaxMT
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.md import Langevin as JaxLangevin
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch import units
from autoforce_tpu_torch.calculator import MultiTaskCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.md import Langevin, VelocityVerlet
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.regression.sgpr import InducingEnv
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_torch_bcm import inside

FS = units.fs
assert jax_units.fs == FS
KW = dict(kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2), pckl=None, tape=None)
JAXPKG = dict(MT=JaxMT, LJ=JaxLJ, fcc=jax_bulk_fcc, mb=jax_mb,
              Langevin=JaxLangevin, kw={})
PORT = dict(MT=MultiTaskCalculator, LJ=LennardJones, fcc=bulk_fcc,
            mb=maxwell_boltzmann_velocities, Langevin=Langevin,
            kw=dict(device="cpu", dtype=torch.float64))


@pytest.fixture(autouse=True)
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make(pkg, logfile=None, **kw):
    lj1 = pkg["LJ"](epsilon=0.15, sigma=2.3, rc=4.0)
    lj2 = pkg["LJ"](epsilon=0.30, sigma=2.3, rc=4.0)
    return pkg["MT"]([lj1, lj2], logfile=logfile, **KW, **kw, **pkg["kw"])


def learned(pkg, tmp, weights, steps=15, **kw):
    """The JAX test's learning run: Langevin 300 K from a rattled cell."""
    with inside(tmp):
        calc = make(pkg, logfile="active.log", weights=weights, ediff=0.01,
                    ediff_tot=0.05, fdiff=0.05, **kw)
        s = pkg["fcc"]("Cu", 3.6)
        s.rattle(0.05, seed=3)
        s.calc = calc
        pkg["mb"](s, 300, seed=4)
        pkg["Langevin"](s, 2 * FS, 300, friction=0.02, seed=5).run(steps)
    return calc, s


def both(tmp_path, fn):
    out = {}
    for name, pkg in (("jax", JAXPKG), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        out[name] = fn(pkg, str(d))
    return out["jax"], out["port"]


def test_multitask_two_lj(tmp_path):
    """Both energy scales learned alike; weights [1, 0] serve task 1 and
    a switch to [0, 1] serves task 2."""
    (jc, js), (pc, ps) = both(
        tmp_path, lambda pkg, d: learned(pkg, d, [1.0, 0.0]))
    assert pc.size == jc.size
    np.testing.assert_allclose(pc.model.mu_tasks, jc.model.mu_tasks,
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(ps.positions, js.positions, atol=1e-9)
    jr, pr = jc.calculate(js), pc.calculate(ps)
    np.testing.assert_allclose(pr["task_energies"], jr["task_energies"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(pr["forces"], jr["forces"], rtol=0, atol=1e-8)
    e1, e2 = pr["task_energies"]
    refs = []
    for eps in (0.15, 0.30):
        t = ps.copy()
        t.calc = LennardJones(epsilon=eps, sigma=2.3, rc=4.0)
        refs.append(t.get_potential_energy())
    assert abs(e1 - refs[0]) / len(ps) < 0.05, (e1, refs[0])
    assert abs(e2 - refs[1]) / len(ps) < 0.1, (e2, refs[1])
    assert abs(pr["energy"] - e1) < 1e-6
    for c in (jc, pc):
        c.set_weights([0.0, 1.0])
    jr2, pr2 = jc.calculate(js.copy()), pc.calculate(ps.copy())
    assert abs(pr2["energy"] - jr2["energy"]) < 1e-8
    assert abs(pr2["energy"] - e2) < 0.2, (pr2["energy"], e2)


def test_multitask_weights_sampling_and_ti(tmp_path):
    """weights_sample jumps to another one-hot on schedule; the TI
    schedule walks weights_init -> weights_fin; both as in JAX."""

    def sampled(pkg, d):
        with inside(d):
            calc = make(pkg, logfile="active.log", weights=[1.0, 0.0],
                        weights_sample=4, ediff=0.02, ediff_tot=0.05,
                        fdiff=0.1, seed=0)
            s = pkg["fcc"]("Cu", 3.6)
            s.rattle(0.05, seed=3)
            s.calc = calc
            rng = np.random.default_rng(8)
            seen = []
            for _ in range(9):
                s.get_potential_energy()
                s.set_positions(s.positions
                                + rng.normal(0, 0.002, s.positions.shape))
                seen.append(tuple(np.round(calc.weights, 6)))
            calc2 = make(pkg, weights=[1.0, 0.0], weights_fin=[0.0, 1.0],
                         t_tieq=2, ediff=0.02, ediff_tot=0.05, fdiff=0.1,
                         seed=0)
            t = pkg["fcc"]("Cu", 3.6)
            t.rattle(0.05, seed=4)
            t.calc = calc2
            for _ in range(10):
                t.get_potential_energy()
                t.set_positions(t.positions
                                + rng.normal(0, 0.002, t.positions.shape))
            log = [line.split(" ", 2)[-1] for line in open("active.log")
                   if "weights sample" in line]
        return seen, calc2.weights.copy(), log, calc.size

    (jseen, jw, jlog, jsize), (pseen, pw, plog, psize) = both(tmp_path,
                                                              sampled)
    assert pseen == jseen and plog == jlog and psize == jsize
    np.testing.assert_allclose(pw, jw, rtol=0, atol=1e-12)
    assert len(set(pseen)) >= 2
    for w in pseen:
        assert abs(sum(w) - 1.0) < 1e-9 and max(w) == 1.0
    assert pw[1] > 0.0
    assert plog


def test_multitask_bond_restraints(tmp_path):
    """The harmonic bond restraint 2 k (d - d0)^2 on the pair (0, 1) with
    its pair forces, as in JAX."""
    out = {}
    for name, pkg in (("jax", JAXPKG), ("port", PORT)):
        s = pkg["fcc"]("Cu", 3.6)
        s.rattle(0.05, seed=5)
        res = []
        for ij in (None, [(0, 1)]):
            t = s.copy()
            t.calc = make(pkg, weights=[1.0, 0.0], ediff=0.02,
                          ediff_tot=0.05, fdiff=0.1, seed=0, ij=ij, k=2.0,
                          d0=2.0)
            with inside(str(tmp_path)):
                res.append((t.get_potential_energy(), t.get_forces().copy(),
                            t.calc._mic_vector(0, 1)))
        out[name] = res
    (e_free, f_free, _), (e_rest, f_rest, r) = out["port"]
    d = np.linalg.norm(r)
    np.testing.assert_allclose(e_rest - e_free, 2.0 * 2.0 * (d - 2.0) ** 2,
                               atol=1e-8)
    fpair = -2.0 * 2.0 * (d - 2.0) / d * r
    np.testing.assert_allclose(f_rest[0] - f_free[0], -fpair, atol=1e-8)
    np.testing.assert_allclose(f_rest[1] - f_free[1], fpair, atol=1e-8)
    np.testing.assert_allclose(f_rest[2:], f_free[2:], atol=1e-8)
    for (je, jf, _), (pe, pf, _) in zip(out["jax"], out["port"]):
        assert abs(pe - je) < 1e-8
        np.testing.assert_allclose(pf, jf, rtol=0, atol=1e-8)


def test_multitask_trial_reject_restores_task_state(tmp_path):
    """add_1inducing's reject path restores the multi-task solve fields:
    a stale (m+1)-row mu_tasks against an m-column model would break
    effective_mu and predict_task_energies."""
    calc = make(PORT, ediff=0.02, ediff_tot=0.05, fdiff=0.05)
    s = bulk_fcc("Cu", 3.6)
    s.rattle(0.05, seed=3)
    s.calc = calc
    with inside(str(tmp_path)):
        s.get_potential_energy()  # seed + solve
    model = calc.model
    m0 = model.m
    mu0 = model.mu.copy()
    mt0 = model.mu_tasks.copy()
    env = model.X[-1]
    env2 = InducingEnv.from_arrays(env.number, env.rvec * 1.001, env.numbers)
    added, _ = model.add_1inducing(env2, ediff=1e9)
    assert added == 0
    assert model.m == m0
    assert model.mu_tasks.shape == mt0.shape
    np.testing.assert_allclose(model.mu, mu0, atol=1e-12)
    np.testing.assert_allclose(model.mu_tasks, mt0, atol=1e-12)
    with inside(str(tmp_path)):
        res = calc.calculate(s)
    assert np.isfinite(res["energy"])
    assert len(res["task_energies"]) == 2


def test_device_md_multitask_static(tmp_path):
    """Static weights make a plain SGPR surface with mu =
    effective_mu(weights): DeviceMD integrates it as the host driver
    does, and as the JAX package's DeviceMD; a weight change reaches the
    card (the staged arrays are restaged)."""
    (jc, js), (pc, ps) = both(
        tmp_path, lambda pkg, d: learned(pkg, d, [0.7, 0.3], steps=12))
    for c in (jc, pc):
        c._calc = None  # inference: deterministic comparison

    def run(pkg, calc, s0, device):
        s = s0.copy()
        pkg["mb"](s, 300, seed=9)
        s.calc = calc
        if device:
            kw = dict(device_rebuild=False) if pkg is JAXPKG else {}
            D = JaxDeviceMD if pkg is JAXPKG else DeviceMD
            D(s, calc, dt=2 * FS, chunk=3, check_beta=False,
              thermostat="none", **kw).run(8)
        else:
            VelocityVerlet(s, 2 * FS).run(8)
        return s.positions.copy(), s.get_velocities().copy()

    host = run(PORT, pc, ps, False)
    dev = run(PORT, pc, ps, True)
    jdev = run(JAXPKG, jc, js, True)
    for a, b in zip(dev, host):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(dev, jdev):
        np.testing.assert_allclose(a, b, atol=1e-9)
    pc.set_weights([0.0, 1.0])
    assert np.abs(run(PORT, pc, ps, True)[0] - dev[0]).max() > 1e-6
    np.testing.assert_allclose(run(PORT, pc, ps, True)[0],
                               run(PORT, pc, ps, False)[0], atol=1e-9)
