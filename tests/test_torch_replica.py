"""Replica ensembles on the port against the JAX package (CPU, float64):
the stacked replica chunk against each walker's own chunk, the NVE and
Nose-Hoover chunks against the JAX package's ``md_chunk_replicas``,
``ReplicaMD`` against the JAX package's (NVE and NHC), each Langevin walker
against ``DeviceMD`` on its noise stream, ensemble learning against the
JAX package, and ``cl md`` with ``replicas = 2``.

The walkers are 108-atom Cu boxes (the MIC rebuild holds at rc + skin, so
the port rebuilds tables inside its chunks) served by the 32-atom Cu model
of tests/test_torch_npt.py, which both packages load.

Tolerances: 1e-10 A and A/fs between a walker in the stacked chunk and
the same walker alone (the same arithmetic on other rows; 1e-9 for the
largest beta, whose sqrt(1 - c) amplifies the rounding of c), 1e-9 A against
the JAX package (its own replica test holds 1e-10 against its chunk, 1e-9
against DeviceMD; here the row orders of the two tables differ);
ensemble learning: the same model sizes and 1e-8 A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.md.device_md import md_chunk_replicas as jax_replicas
from autoforce_tpu.md.replica_md import ReplicaMD as JaxReplicaMD
from autoforce_tpu.neighbors import neighbor_table as jax_table
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch import units
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.md import device_md as dmd
from autoforce_tpu_torch.md.device_md import (DeviceMD, md_chunk,
                                              md_chunk_replicas)
from autoforce_tpu_torch.md.replica_md import ReplicaMD
from autoforce_tpu_torch.neighbors import neighbor_table
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_torch_bcm import inside
from test_torch_npt import calc_pair, trained_folder  # noqa: F401

FS = units.fs
SKIN = 0.3
R = 3


def walkers(pkg, n=R, temperature=400, seed0=20):
    """``n`` rattled, thermalized 108-atom Cu boxes of one package."""
    fcc, mb = ((jax_bulk_fcc, jax_mb) if pkg == "jax"
               else (bulk_fcc, maxwell_boltzmann_velocities))
    out = []
    for r in range(n):
        s = fcc("Cu", 3.6).repeat((3, 3, 3))
        s.rattle(0.05, seed=seed0 + r)
        mb(s, temperature, seed=seed0 + 20 + r)
        out.append(s)
    return out


def chunk_inputs(pc, systems, kpad=64):
    """The port's chunk inputs for each walker: its config at rc + skin,
    velocities, masses, vscale and the rebuild's species tables."""
    eng = pc.engine
    cut = eng.params.rc + SKIN
    cfgs = [eng.make_config(s, kpad=kpad, table=neighbor_table(
        s.positions, s.cell, s.pbc, cut).pad_to(kpad)) for s in systems]
    npad = cfgs[0].npad
    n = len(systems[0])

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    vel = np.zeros((len(systems), npad, 3))
    for r, s in enumerate(systems):
        vel[r, :n] = s.get_velocities()
    masses = np.ones((npad, 1))
    masses[:n, 0] = systems[0].get_masses()
    vs = np.ones(npad)
    vs[:n] = pc.model.vscale_for(systems[0].numbers)
    sidx = eng.species_index(cfgs[0].numbers.numpy())
    return dict(cfgs=cfgs, vel=t(vel), masses=t(masses), vs=t(vs),
                ma=pc.model.full_model_arrays(), radii=eng.radii_table(),
                sidx_atom=t(np.maximum(sidx, 0), torch.int32),
                sidx_ok=t(sidx >= 0, torch.bool), cut=cut)


def nhc_kw(n, walkers=None):
    Q = torch.tensor([3.0, 1.0, 1.0], dtype=torch.float64)
    shape = (3,) if walkers is None else (walkers, 3)
    return dict(nhc_Q=Q, nhc_dof=3.0 * n,
                nhc_vxi=torch.zeros(shape, dtype=torch.float64),
                nhc_xi=torch.zeros(shape, dtype=torch.float64))


@pytest.mark.parametrize("thermostat", ["langevin", "nhc"])
@pytest.mark.parametrize("rebuild", [False, True])
def test_replica_chunk_matches_separate_chunks(trained_folder, thermostat,  # noqa: F811
                                               rebuild):
    """Each walker of the stacked chunk follows its own md_chunk (stream
    seeds[r]), with and without the in-loop rebuild of every table."""
    _, pc = calc_pair(trained_folder)
    systems = walkers("port", temperature=900)
    a = chunk_inputs(pc, systems)
    n = len(systems[0])
    seeds = [7, 11, 3]
    kw = dict(params=pc.engine.params, exponent=pc.engine.exponent,
              check_beta=True, thermostat=thermostat)
    if rebuild:
        kw.update(rebuild=True, rebuild_cut=a["cut"],
                  sidx_atom=a["sidx_atom"], sidx_ok=a["sidx_ok"])
    skin_half = 0.5 * SKIN if rebuild else 10.0
    steps = 60 if rebuild else 12
    pos0 = torch.stack([c.positions for c in a["cfgs"]])
    out_r = md_chunk_replicas(
        a["cfgs"], a["ma"], a["radii"], a["vs"], a["vel"], a["masses"], pos0,
        2 * FS, 0.03, 0.02, skin_half, 1e9, steps, seeds=seeds, **kw,
        **(nhc_kw(n, R) if thermostat == "nhc" else {}))
    assert int(out_r[5]) == steps
    if rebuild:  # the tables were rebuilt on the way
        assert not torch.equal(out_r[7], pos0.reshape(-1, 3))
    for r in range(R):
        one = md_chunk(
            a["cfgs"][r], a["ma"], a["radii"], a["vs"], a["vel"][r],
            a["masses"], pos0[r], 2 * FS, 0.03, 0.02, skin_half, 1e9, steps,
            seed=seeds[r], **kw, **(nhc_kw(n) if thermostat == "nhc" else {}))
        assert int(one[5]) == steps
        for k in range(3):  # positions, velocities, forces
            np.testing.assert_allclose(out_r[k][r].numpy(), one[k].numpy(),
                                       rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(out_r[3][r]), float(one[3]),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(out_r[4][r]), float(one[4]),
                                   rtol=0, atol=1e-9)
        if thermostat == "nhc":
            np.testing.assert_allclose(out_r[-2][r].numpy(),
                                       one[-2].numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("thermostat", ["none", "nhc"])
def test_replica_chunk_matches_jax(trained_folder, thermostat):  # noqa: F811
    """The deterministic chunks (NVE, NHC) against the JAX package's
    md_chunk_replicas on the same walkers and model."""
    jc, pc = calc_pair(trained_folder)
    jsys, psys = walkers("jax"), walkers("port")
    a = chunk_inputs(pc, psys)
    jeng = jc.engine
    cut = jeng.params.rc + SKIN
    jcfgs = [jeng.make_config(s, kpad=64, table=jax_table(
        s.positions, s.cell, s.pbc, cut).pad_to(64)) for s in jsys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jcfgs)
    n = len(psys[0])
    steps = 10
    jnhc = {}
    if thermostat == "nhc":
        jnhc = dict(nhc_Q=jnp.asarray([3.0, 1.0, 1.0]),
                    nhc_dof=jnp.asarray(3.0 * n),
                    nhc_vxi=jnp.zeros((R, 3)), nhc_xi=jnp.zeros((R, 3)))
    j = jax_replicas(
        stacked, jc.model.full_model_arrays(), jeng.radii_table(),
        jeng.znum_table(), jnp.asarray(a["vs"].numpy()),
        jnp.asarray(a["vel"].numpy()), jnp.asarray(a["masses"].numpy()),
        stacked.positions, jax.random.split(jax.random.PRNGKey(0), R),
        jnp.asarray(2 * FS), jnp.asarray(0.03), jnp.asarray(0.0),
        jnp.asarray(10.0), jnp.asarray(1e9), jnp.asarray(steps, np.int32),
        *jeng.chem_args(), params=jeng.params, exponent=jeng.exponent,
        pair_terms=(), check_beta=True, thermostat=thermostat, kind="dot",
        **jnhc)
    pos0 = torch.stack([c.positions for c in a["cfgs"]])
    t = md_chunk_replicas(
        a["cfgs"], a["ma"], a["radii"], a["vs"], a["vel"], a["masses"], pos0,
        2 * FS, 0.03, 0.0, 10.0, 1e9, steps, seeds=[0, 1, 2],
        params=pc.engine.params, exponent=pc.engine.exponent,
        check_beta=True, thermostat=thermostat,
        **(nhc_kw(n, R) if thermostat == "nhc" else {}))
    assert int(j[6]) == int(t[5]) == steps
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-9)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-9)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[4]), rtol=1e-10)
    np.testing.assert_allclose(t[4].numpy(), np.asarray(j[5]), rtol=1e-8)
    if thermostat == "nhc":
        np.testing.assert_allclose(t[-2].numpy(), np.asarray(j[7]), atol=1e-10)


@pytest.mark.parametrize("thermostat", ["none", "nhc"])
def test_replica_md_driver_matches_jax(trained_folder, thermostat):  # noqa: F811
    """The ensemble drivers of both packages, 2 walkers at 900 K, 40 steps
    in chunks of 7: the port rebuilds the tables inside its chunks, the
    JAX package between them."""
    out = {}
    for pkg in ("jax", "port"):
        jc, pc = calc_pair(trained_folder)
        calc = jc if pkg == "jax" else pc
        systems = walkers(pkg, n=2, temperature=900)
        Driver = JaxReplicaMD if pkg == "jax" else ReplicaMD
        dyn = Driver(systems, calc, dt=2 * FS, chunk=7, check_beta=False,
                     thermostat=thermostat, temperature_K=900,
                     tdamp=20 * FS)
        dyn.run(40)
        assert dyn.nsteps == 40
        out[pkg] = [s.positions.copy() for s in systems]
        if pkg == "port":
            assert dyn.in_loop_rebuild
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert np.abs(out["port"][0] - out["port"][1]).max() > 0.05


def test_langevin_walker_matches_device_md(trained_folder, monkeypatch):  # noqa: F811
    """Walker r of a Langevin ensemble (seed 5) is DeviceMD on stream
    5 + r, skin breaches served inside the chunks of both."""
    _, pc = calc_pair(trained_folder)
    calls = []
    real = dmd._inloop_table

    def counting(*a, **k):
        cfg_with, tbl0, rebuild_fn = real(*a, **k)

        def rb(*x, **y):
            calls.append(1)
            return rebuild_fn(*x, **y)
        return cfg_with, tbl0, rb if rebuild_fn else None

    monkeypatch.setattr(dmd, "_inloop_table", counting)
    systems = walkers("port", temperature=900)
    ens = ReplicaMD(systems, pc, 2 * FS, temperature_K=900, friction=0.02,
                    chunk=25, seed=5)
    ens.run(60)
    assert calls, "no in-loop rebuild in the ensemble run"
    for r, s in enumerate(walkers("port", temperature=900)):
        s.calc = pc
        DeviceMD(s, pc, 2 * FS, temperature_K=900, friction=0.02, chunk=25,
                 seed=5 + r).run(60)
        np.testing.assert_allclose(systems[r].positions, s.positions,
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(systems[r].get_velocities(),
                                   s.get_velocities(), rtol=0, atol=1e-9)


def test_replica_md_ensemble_active_learning(tmp_path):
    """Learning from an ensemble (JAX's test, NVE so that no random number
    differs between the packages): the tripping walker samples, the
    updated model serves every walker, in both packages alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for pkg in ("jax", "port"):
            d = tmp_path / pkg
            d.mkdir()
            with inside(str(d)):
                kw = dict(covariance=None, logfile="active.log", pckl=None,
                          tape=None, kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2),
                          ediff=0.05, ediff_tot=0.1, fdiff=0.2, seed=0,
                          ioptim=10**6)
                if pkg == "jax":
                    calc = JaxCalc(calculator=JaxLJ(epsilon=0.15, sigma=2.3,
                                                    rc=4.0), **kw)
                else:
                    calc = ActiveCalculator(
                        calculator=LennardJones(epsilon=0.15, sigma=2.3,
                                                rc=4.0),
                        device="cpu", dtype=torch.float64, **kw)
                fcc, mb = ((jax_bulk_fcc, jax_mb) if pkg == "jax"
                           else (bulk_fcc, maxwell_boltzmann_velocities))
                systems = []
                for r in range(2):
                    s = fcc("Cu", 3.6).repeat((2, 2, 1))
                    s.rattle(0.03, seed=50 + r)
                    s.calc = calc
                    mb(s, 200, seed=60 + r)
                    systems.append(s)
                systems[0].get_potential_energy()  # seed the model
                assert calc.size[1] > 0
                size0 = calc.size
                Driver = JaxReplicaMD if pkg == "jax" else ReplicaMD
                dyn = Driver(systems, calc, dt=2 * FS, chunk=10,
                             thermostat="none")
                assert dyn.check_beta
                dyn.run(30)
                assert dyn.nsteps >= 30
                out[pkg] = (calc.size, size0, [s.positions.copy()
                                               for s in systems])
    finally:
        torch.set_num_threads(threads)
    (jsize, jsize0, jpos), (psize, psize0, ppos) = out["jax"], out["port"]
    assert psize == jsize and psize0 == jsize0
    assert psize != psize0, "the ensemble sampled nothing"
    for a, b in zip(ppos, jpos):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
