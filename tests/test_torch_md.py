"""Device-resident MD of the port against the JAX package (CPU, float64):
NVE ``md_chunk`` trajectories with and without the in-loop neighbor
rebuild, the uncertainty trip, ``DeviceMD`` through the calculator, and the
Langevin thermostat's seeded reproducibility and temperature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.engine import Engine as JaxEngine
from autoforce_tpu.io.model_io import save_model
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.md.device_md import md_chunk as jax_md_chunk
from autoforce_tpu.neighbors import displacements, neighbor_table
from autoforce_tpu.regression.sgpr import InducingEnv, SgprModel
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.io.convert import config_from_numpy, model_arrays_from_numpy
from autoforce_tpu_torch.md.device_md import DeviceMD, md_chunk
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

RC, SKIN = 4.5, 0.3
PARAMS = dict(lmax=2, nmax=2, rc=RC)
DT = 2 * units.fs


def t64(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def chunk_setup():
    """A 108-atom Cu box where the MIC rebuild holds at rc + skin, its
    padded table at rc + skin, random model arrays around its own
    descriptors (JAX side), and their carried-over counterparts."""
    eng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4, species=[29])
    s = jax_bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    s.rattle(0.05, seed=1)
    table = neighbor_table(s.positions, s.cell, s.pbc, RC + SKIN)
    cfg = eng.make_config(s, kpad=64, table=table.pad_to(64))
    rng = np.random.default_rng(0)
    p = np.asarray(eng.descriptors(cfg)[0])[: len(s)]
    m = 24
    X = p[rng.choice(len(s), m, replace=False)] + 0.01 * rng.normal(size=(m, p.shape[1]))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    ma = eng.model_arrays(X, np.full(m, 29, np.int32), np.zeros(m, bool),
                          0.5 * rng.normal(size=m),
                          0.02 * np.tril(rng.normal(size=(m, m))))
    tma = model_arrays_from_numpy(
        *(np.asarray(a) for a in (ma.X_desc, ma.X_num, ma.X_lone, ma.mu, ma.choli)),
        device="cpu", dtype=torch.float64, m_mask=np.asarray(ma.m_mask))
    tcfg = config_from_numpy(*(None if a is None else np.asarray(a) for a in cfg),
                             device="cpu", dtype=torch.float64)
    npad = cfg.npad
    vel = np.zeros((npad, 3))
    vel[: len(s)] = 0.02 * rng.normal(size=(len(s), 3))
    masses = np.ones((npad, 1))
    masses[: len(s), 0] = s.get_masses()
    return dict(eng=eng, s=s, cfg=cfg, ma=ma, tcfg=tcfg, tma=tma, vel=vel,
                masses=masses, vs=np.ones(npad), n=len(s))


def run_both(su, nsteps, skin_half, bthr, rebuild, cfg=None, tcfg=None, vel=None):
    eng = su["eng"]
    cfg = su["cfg"] if cfg is None else cfg
    tcfg = su["tcfg"] if tcfg is None else tcfg
    vel = su["vel"] if vel is None else vel
    pos0 = np.asarray(cfg.positions)
    sidx = np.zeros(cfg.npad, np.int32)
    sok = np.asarray(cfg.atom_mask)
    jkw = tkw = {}
    if rebuild:
        jkw = dict(rebuild=True, rebuild_cut=jnp.asarray(RC + SKIN),
                   sidx_atom=jnp.asarray(sidx), sidx_ok=jnp.asarray(sok))
        tkw = dict(rebuild=True, rebuild_cut=RC + SKIN,
                   sidx_atom=t64(sidx, torch.int32), sidx_ok=t64(sok, torch.bool))
    j = jax_md_chunk(
        cfg, su["ma"], eng.radii_table(), eng.znum_table(), jnp.asarray(su["vs"]),
        jnp.asarray(vel), jnp.asarray(su["masses"]), jnp.asarray(pos0),
        jax.random.PRNGKey(0), DT, 0.0, 0.0, skin_half, bthr,
        jnp.asarray(nsteps), params=eng.params, exponent=4, check_beta=True,
        thermostat="none", **jkw)
    t = md_chunk(
        tcfg, su["tma"], t64(eng.radii_table()), t64(su["vs"]), t64(vel),
        t64(su["masses"]), t64(pos0), DT, 0.0, 0.0, skin_half, bthr, nsteps,
        params=SoapParams(**PARAMS), exponent=4, check_beta=True,
        thermostat="none", **tkw)
    return j, t


def assert_same_state(j, t):
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-9)  # pos
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-9)  # vel
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[3]), atol=1e-9)  # f
    np.testing.assert_allclose(float(t[3]), float(j[4]), rtol=1e-9)  # e
    np.testing.assert_allclose(float(t[4]), float(j[5]), rtol=1e-9)  # beta_max


def test_nve_chunk_stops_on_skin_breach_like_jax(chunk_setup):
    j, t = run_both(chunk_setup, 40, 0.5 * SKIN, 1e9, rebuild=False)
    ndone = int(j[6])
    assert 0 < ndone < 40
    assert int(t[5]) == ndone
    assert_same_state(j, t)


def test_nve_chunk_with_inloop_rebuild_matches_jax(chunk_setup):
    j, t = run_both(chunk_setup, 40, 0.5 * SKIN, 1e9, rebuild=True)
    assert int(j[6]) == int(t[5]) == 40
    assert_same_state(j, t)
    jtbl, jp0 = j[9], j[10]
    ttbl, tp0 = t[6], t[7]
    # the table was rebuilt on the way (its origin moved) and agrees
    assert np.abs(np.asarray(jp0) - np.asarray(chunk_setup["cfg"].positions)).max() > 0
    np.testing.assert_allclose(tp0.numpy(), np.asarray(jp0), atol=1e-9)
    for a, b in zip(ttbl, jtbl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_inloop_rebuild_chains_across_chunks(chunk_setup):
    # two 20-step chunks, the second started from the first one's live
    # table and origin (as DeviceMD chains them), land where JAX's single
    # 40-step chunk does
    su = chunk_setup
    j, _ = run_both(su, 40, 0.5 * SKIN, 1e9, rebuild=True)
    t_first = md_chunk(
        su["tcfg"], su["tma"], t64(su["eng"].radii_table()), t64(su["vs"]),
        t64(su["vel"]), t64(su["masses"]), su["tcfg"].positions, DT, 0.0, 0.0,
        0.5 * SKIN, 1e9, 20, params=SoapParams(**PARAMS), exponent=4,
        thermostat="none", rebuild=True, rebuild_cut=RC + SKIN,
        sidx_atom=torch.zeros(su["tcfg"].npad, dtype=torch.int32),
        sidx_ok=su["tcfg"].atom_mask)
    pos, vel, *_, tbl, p0 = t_first
    idx, off, sx, mk, rv = tbl
    cfg2 = su["tcfg"]._replace(positions=pos, nbr_idx=idx, nbr_off=off,
                               nbr_sidx=sx, nbr_mask=mk, nbr_rev=rv)
    t = md_chunk(
        cfg2, su["tma"], t64(su["eng"].radii_table()), t64(su["vs"]), vel,
        t64(su["masses"]), p0, DT, 0.0, 0.0, 0.5 * SKIN, 1e9, 20,
        params=SoapParams(**PARAMS), exponent=4, thermostat="none",
        rebuild=True, rebuild_cut=RC + SKIN,
        sidx_atom=torch.zeros(su["tcfg"].npad, dtype=torch.int32),
        sidx_ok=su["tcfg"].atom_mask)
    assert int(t_first[5]) == int(t[5]) == 20
    assert_same_state(j, t)
    np.testing.assert_allclose(t[7].numpy(), np.asarray(j[10]), atol=1e-9)


def test_failed_inloop_rebuild_stops_like_jax(chunk_setup):
    # a bucket too small for the rebuilt table (the incoming one is cut to
    # it as well): the loop keeps the last good table and stops on the
    # breach step
    su = chunk_setup
    cfg = su["cfg"]
    k = int(np.asarray(cfg.nbr_mask).sum(1).max()) - 2
    cut = lambda a: a[:, :k]  # noqa: E731
    small = cfg._replace(nbr_idx=cut(cfg.nbr_idx), nbr_off=cut(cfg.nbr_off),
                         nbr_sidx=cut(cfg.nbr_sidx), nbr_mask=cut(cfg.nbr_mask),
                         nbr_rev=None)
    tsmall = su["tcfg"]._replace(
        nbr_idx=su["tcfg"].nbr_idx[:, :k], nbr_off=su["tcfg"].nbr_off[:, :k],
        nbr_sidx=su["tcfg"].nbr_sidx[:, :k], nbr_mask=su["tcfg"].nbr_mask[:, :k],
        nbr_rev=None)
    j, t = run_both(su, 40, 0.5 * SKIN, 1e9, rebuild=True, cfg=small,
                    tcfg=tsmall, vel=4 * su["vel"])
    ndone = int(j[6])
    assert 0 < ndone < 40 and int(t[5]) == ndone
    assert_same_state(j, t)
    np.testing.assert_allclose(t[7].numpy(), np.asarray(j[10]), atol=1e-12)


def test_uncertainty_trip_stops_on_the_same_step(chunk_setup):
    su = chunk_setup
    # beta_max along a trajectory without trips (one step per call)
    cfg, vel, betas = su["tcfg"], t64(su["vel"]), []
    for _ in range(12):
        out = md_chunk(cfg, su["tma"], t64(su["eng"].radii_table()), t64(su["vs"]),
                       vel, t64(su["masses"]), cfg.positions, DT, 0.0, 0.0, 1e9,
                       1e9, 1, params=SoapParams(**PARAMS), exponent=4,
                       check_beta=True, thermostat="none")
        cfg, vel = cfg._replace(positions=out[0]), out[1]
        betas.append(float(out[4]))
    # a threshold that the trajectory first crosses after a few steps
    run_max = np.maximum.accumulate(betas)
    step = next(i for i in range(3, 12) if betas[i] > run_max[i - 1] * (1 + 1e-6))
    bthr = 0.5 * (betas[step] + run_max[step - 1])
    j, t = run_both(su, 40, 1e9, bthr, rebuild=False)
    assert int(j[6]) == int(t[5]) == step + 1
    assert float(t[4]) >= bthr
    assert_same_state(j, t)


@pytest.fixture(scope="module")
def model_folder(tmp_path_factory):
    """A small trained-looking SGPR model folder written by the JAX package."""
    eng = JaxEngine(params=JaxSoapParams(**PARAMS), exponent=4, species=[29])
    model = SgprModel(eng)
    s = jax_bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.08, seed=2)
    t = neighbor_table(s.positions, s.cell, s.pbc, RC)
    r = displacements(s.positions, s.cell, t)
    for i in range(16):
        m = t.mask[i]
        model.X.append(InducingEnv.from_arrays(29, r[i][m], s.numbers[t.idx[i][m]]))
    model.restage()
    rng = np.random.default_rng(1)
    model.mu = 0.3 * rng.normal(size=16)
    model.choli = 0.02 * np.tril(rng.normal(size=(16, 16)))
    model.vscale = {29: 1.5}
    model.mean_weights = {29: -0.25}
    folder = str(tmp_path_factory.mktemp("model") / "model.pckl")
    save_model(model, folder)
    return folder


@pytest.mark.parametrize("in_loop", [True, False])
def test_device_md_nve_matches_jax(model_folder, in_loop, monkeypatch):
    # the box admits the in-loop device rebuild; the host path (a breach
    # ends the chunk, the host rebuilds) is what runs where the MIC gate
    # refuses the box, so that gate is made to refuse it
    if not in_loop:
        import autoforce_tpu_torch.neighbors_device as nd

        monkeypatch.setattr(nd, "device_rebuild_ok", lambda *a: False)
    jcalc = JaxCalc(covariance=model_folder, calculator=None, logfile=None,
                    pckl=None, tape=None, skin=SKIN)
    js = jax_bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    js.rattle(0.05, seed=1)
    js.calc = jcalc
    jax_mb(js, 600, seed=3)
    kw = dict(dt=DT, chunk=25, check_beta=False, thermostat="none")
    jd = JaxDeviceMD(js, jcalc, in_loop_rebuild=in_loop, device_rebuild=in_loop,
                     **kw)
    jd.run(60)
    calc = ActiveCalculator(covariance=model_folder, calculator=None, skin=SKIN,
                            device="cpu", dtype=torch.float64)
    ts = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    ts.rattle(0.05, seed=1)
    ts.calc = calc
    maxwell_boltzmann_velocities(ts, 600, seed=3)
    td = DeviceMD(ts, calc, **kw)
    assert td.in_loop_rebuild == jd.in_loop_rebuild == in_loop
    td.run(60)
    assert td.nsteps == jd.nsteps == 60
    np.testing.assert_allclose(ts.positions, js.positions, atol=1e-9)
    np.testing.assert_allclose(ts.get_velocities(), js.get_velocities(), atol=1e-9)
    np.testing.assert_allclose(ts.get_potential_energy(), js.get_potential_energy(),
                               rtol=1e-10)


def langevin_run(folder, seed, chunk, steps=20, temperature=300, friction=0.02):
    calc = ActiveCalculator(covariance=folder, calculator=None, skin=SKIN,
                            device="cpu", dtype=torch.float64)
    s = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    s.rattle(0.05, seed=1)
    s.calc = calc
    maxwell_boltzmann_velocities(s, temperature, seed=3)
    dyn = DeviceMD(s, calc, dt=DT, temperature_K=temperature, friction=friction,
                   chunk=chunk, seed=seed, check_beta=False)
    return s, dyn


def test_langevin_is_reproducible_across_chunkings(model_folder):
    a, da = langevin_run(model_folder, seed=5, chunk=7)
    da.run(20)
    b, db = langevin_run(model_folder, seed=5, chunk=20)
    db.run(20)
    c, dc = langevin_run(model_folder, seed=6, chunk=7)
    dc.run(20)
    assert da.thermostat == "langevin"
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.get_velocities(), b.get_velocities())
    assert np.abs(a.positions - c.positions).max() > 1e-4


def test_langevin_holds_the_temperature(model_folder):
    # zero weights: no forces, so the kinetic temperature is the bath's
    s, dyn = langevin_run(model_folder, seed=0, chunk=25, temperature=300,
                          friction=0.5)
    model = dyn.calc.model
    model.mu = np.zeros_like(model.mu)
    model._model_arrays = None
    dyn.run(100)
    temps = []
    for _ in range(20):
        dyn.run(5)
        temps.append(s.get_temperature())
    assert np.isfinite(s.positions).all()
    assert abs(np.mean(temps) / 300 - 1) < 0.15, np.mean(temps)
