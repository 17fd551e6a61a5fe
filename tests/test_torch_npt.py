"""The port's Nose-Hoover and MTK NPT drivers against the JAX package (CPU,
float64): ``DeviceMD(thermostat="nhc")``, ``DeviceNPT`` isotropic and
flexible-cell, the in-loop rebuild under the moving cell, the strain
gradient of ``_sgpr_forces_virial``, the explicit 3x3 helpers, and an
uncertainty trip under NPT.  Each driver runs on the same trained 32-atom
Cu model, written once by the JAX package and loaded by both.

Tolerances: 1e-8 A / A/fs for positions, velocities and cells, 1e-10 for
the chain state (the JAX package's own host-vs-device NPT tests), 1e-8
relative for energies and strain gradients; step counts are equal."""

import numpy as np
import pytest
import torch

from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.emt import EMT as JaxEMT
from autoforce_tpu.io.model_io import save_model
from autoforce_tpu.md import Langevin as JaxLangevin
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.md.device_npt import DeviceNPT as JaxDeviceNPT
from autoforce_tpu.md.device_npt import _sgpr_forces_virial as jax_forces_virial
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.md import MTKNPT, NoseHooverNVT
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.md.device_npt import (DeviceNPT, _min_perp_width,
                                               _sgpr_forces_virial, expm_sym)
from autoforce_tpu_torch.neighbors_device import det3, inv3
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

DT = 2 * units.fs
KERNEL = dict(cutoff=4.5, lmax=2, nmax=2)


@pytest.fixture(scope="module")
def trained_folder(tmp_path_factory):
    """A 32-atom Cu model learned on the fly from the JAX package's EMT
    oracle along 12 Langevin steps, frozen and written as a model folder
    (the format both packages load)."""
    tmp = tmp_path_factory.mktemp("trained")
    calc = JaxCalc(covariance=None, calculator=JaxEMT(), logfile=None,
                   pckl=None, tape=None, kernel_kw=KERNEL, ediff=0.02,
                   ediff_tot=0.05, fdiff=0.06, seed=0)
    s = jax_bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=0)
    s.calc = calc
    jax_mb(s, 300, seed=1)
    JaxLangevin(s, DT, 300, friction=0.01, seed=2).run(12)
    folder = str(tmp / "model.pckl")
    save_model(calc.model, folder)
    return folder


def calc_pair(folder, skin=0.3):
    """(JAX calculator, port calculator) serving the same frozen model."""
    kw = dict(covariance=folder, calculator=None, logfile=None, pckl=None,
              tape=None, skin=skin)
    return (JaxCalc(**kw),
            ActiveCalculator(device="cpu", dtype=torch.float64, **kw))


def system_pair(reps=(2, 2, 2), rattle=0.05, temperature=300, a=3.6):
    """The same rattled, thermalized Cu box built by both packages."""
    out = []
    for fcc, mb in ((jax_bulk_fcc, jax_mb),
                    (bulk_fcc, maxwell_boltzmann_velocities)):
        s = fcc("Cu", a).repeat(reps)
        s.rattle(rattle, seed=4)
        if temperature:
            mb(s, temperature, seed=5)
        out.append(s)
    np.testing.assert_array_equal(out[0].positions, out[1].positions)
    return out


def assert_same(a, b, cell=True):
    np.testing.assert_allclose(b.positions, a.positions, atol=1e-8)
    np.testing.assert_allclose(b.get_velocities(), a.get_velocities(),
                               atol=1e-8)
    if cell:
        np.testing.assert_allclose(np.asarray(b.cell), np.asarray(a.cell),
                                   atol=1e-8)


def count_breach_reads(monkeypatch):
    """Count the port's in-loop breach reads (one per served breach)."""
    import contextlib

    import autoforce_tpu_torch.md.device_md as dm

    reads = []
    inner = dm.host_read

    @contextlib.contextmanager
    def counted():
        reads.append(1)
        with inner():
            yield

    monkeypatch.setattr(dm, "host_read", counted)
    return reads


def test_device_md_nhc_matches_jax_and_host(trained_folder):
    jcalc, calc = calc_pair(trained_folder)
    js, ts = system_pair()
    hs = ts.copy()
    kw = dict(temperature_K=300, tdamp=50 * units.fs)
    js.calc = jcalc
    jd = JaxDeviceMD(js, jcalc, DT, chunk=6, check_beta=False,
                     thermostat="nhc", **kw)
    jd.run(15)
    ts.calc = calc
    td = DeviceMD(ts, calc, DT, chunk=6, check_beta=False, thermostat="nhc",
                  **kw)
    td.run(15)
    assert td.nsteps == jd.nsteps == 15
    assert_same(js, ts, cell=False)
    np.testing.assert_allclose(td.nhc_vxi, jd.nhc_vxi, atol=1e-10)
    np.testing.assert_allclose(td.nhc_xi, jd.nhc_xi, atol=1e-10)
    # the host NoseHooverNVT of the port integrates the same chain
    hs.calc = calc
    NoseHooverNVT(hs, DT, **kw).run(15)
    assert_same(hs, ts, cell=False)
    assert np.abs(td.nhc_vxi).max() > 1e-6  # the chain really acted


@pytest.mark.parametrize("mode", ["iso", "aniso", "aniso_masked"])
def test_device_npt_matches_jax_and_host(trained_folder, mode):
    jcalc, calc = calc_pair(trained_folder)
    js, ts = system_pair()
    hs = ts.copy()
    iso = mode == "iso"
    mask = (1, 1, 0) if mode == "aniso_masked" else None
    kw = dict(temperature_K=300, pressure_GPa=0.5, tdamp=50 * units.fs,
              pdamp=200 * units.fs, isotropic=iso, mask=mask)
    js.calc = jcalc
    jd = JaxDeviceNPT(js, jcalc, DT, chunk=4, check_beta=False, **kw)
    jd.run(10)
    ts.calc = calc
    td = DeviceNPT(ts, calc, DT, chunk=4, check_beta=False, **kw)
    td.run(10)
    assert td.nsteps == jd.nsteps == 10
    assert_same(js, ts)
    np.testing.assert_allclose(td.vg, jd.vg, atol=1e-12)
    np.testing.assert_allclose(td.nhc_vxi, jd.nhc_vxi, atol=1e-10)
    np.testing.assert_allclose(td.bch_vxi, jd.bch_vxi, atol=1e-10)
    np.testing.assert_allclose(td.bch_xi, jd.bch_xi, atol=1e-10)
    # the port's host MTKNPT agrees
    hs.calc = calc
    drv = MTKNPT(hs, DT, **kw)
    drv.run(10)
    assert_same(hs, ts)
    hvg = np.trace(drv.vg) / 3.0 if iso else drv.vg
    np.testing.assert_allclose(td.vg, hvg, atol=1e-12)
    # the cell moved, and a masked strain component did not
    c0, c1 = np.asarray(system_pair()[1].cell), np.asarray(ts.cell)
    assert np.abs(c1 - c0).max() > 1e-6
    if mask is not None:
        np.testing.assert_allclose(c1[2], c0[2], atol=1e-12)
        np.testing.assert_allclose(c1[:, 2], c0[:, 2], atol=1e-12)


def test_device_npt_chunked_matches_one_shot(trained_folder):
    _, calc = calc_pair(trained_folder)
    kw = dict(temperature_K=400, pressure_GPa=0.0, tdamp=50 * units.fs,
              pdamp=200 * units.fs, bulk_modulus_GPa=140.0)
    out = []
    for chunk in (12, 3):
        s = system_pair(temperature=400)[1]
        s.calc = calc
        dyn = DeviceNPT(s, calc, DT, chunk=chunk, check_beta=False, **kw)
        dyn.run(12)
        out.append((s.positions.copy(), np.asarray(s.cell).copy()))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-9)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-11)


def test_device_npt_inloop_rebuild_matches_jax(trained_folder, monkeypatch):
    """A 108-atom box admits the device rebuild at rc + skin: skin
    breaches under the moving cell are served inside the chunks of both
    packages (one host read each in the port) and the runs agree."""
    reads = count_breach_reads(monkeypatch)
    jcalc, calc = calc_pair(trained_folder, skin=0.1)
    js, ts = system_pair(reps=(3, 3, 3), temperature=500)
    kw = dict(temperature_K=500, pressure_GPa=1.0, tdamp=50 * units.fs,
              pdamp=100 * units.fs, isotropic=True)
    js.calc = jcalc
    jd = JaxDeviceNPT(js, jcalc, DT, chunk=20, check_beta=False, **kw)
    jd.run(20)
    ts.calc = calc
    td = DeviceNPT(ts, calc, DT, chunk=20, check_beta=False, **kw)
    td.run(20)
    assert td.nsteps == jd.nsteps == 20
    assert_same(js, ts)
    # the 0.1 A skin was breached on the way: the table was rebuilt
    s0 = system_pair(reps=(3, 3, 3), temperature=500)[1]
    assert np.abs(ts.positions - s0.positions).max() > 0.05
    # one host visit: every breach was served in the loop
    assert calc.step == 1 and len(reads) >= 1, (calc.step, len(reads))


def _virial_inputs(folder, aniso):
    jcalc, calc = calc_pair(folder)
    js, ts = system_pair(temperature=0)
    js.calc, ts.calc = jcalc, calc
    js.get_potential_energy()
    ts.get_potential_energy()
    return jcalc, calc, ts


@pytest.mark.parametrize("aniso", [False, True])
def test_strain_gradient_matches_jax_and_finite_difference(trained_folder,
                                                           aniso):
    import jax.numpy as jnp

    jcalc, calc, ts = _virial_inputs(trained_folder, aniso)
    eng, jeng = calc.engine, jcalc.engine
    ma, jma = calc.model.full_model_arrays(), jcalc.model.full_model_arrays()
    cfg, jcfg = calc.cfg, jcalc.cfg
    vs = torch.ones(cfg.npad, dtype=torch.float64)

    def port(cell):
        return _sgpr_forces_virial(cfg.positions @ (cell @ torch.linalg.inv(
            cfg.cell)), cell, cfg, ma, eng.radii_table(), vs, eng.params,
            eng.exponent, True, aniso=aniso)

    e, f, deps, b = port(cfg.cell)
    je, jf, jdeps, jb = jax_forces_virial(
        jcfg.positions, jcfg.cell, jcfg, jma, jeng.radii_table(),
        jeng.znum_table(), jnp.ones(cfg.npad), jeng.params, jeng.exponent,
        jeng.pair_terms, *jeng.chem_args(), jeng.kernel_kind, True,
        aniso=aniso)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-9)
    scale = np.abs(np.asarray(jdeps)).max()
    np.testing.assert_allclose(deps.numpy(), np.asarray(jdeps),
                               atol=1e-8 * scale)
    # beta = sqrt(1 - c) with c within 1e-6 of 1: rounding of c is
    # amplified by 1 / (2 beta), so beta is held to 1e-10 absolute
    np.testing.assert_allclose(float(b), float(jb), atol=1e-10)
    # central differences of the energy along each strain direction,
    # Richardson-extrapolated: the crystal's third strain derivative
    # (~1e4 eV) makes the plain O(h^2) term 2e-5 eV at h = 1e-4, and the
    # rounding of E (~1e-10 eV) grows as 1/h below that: ~2e-6 eV at
    # h = 1e-4, hence 1e-5 of the largest component
    h = 2e-4
    dirs = [np.eye(3)] if not aniso else [
        0.5 * (np.outer(np.eye(3)[i], np.eye(3)[j])
               + np.outer(np.eye(3)[j], np.eye(3)[i]))
        for i in range(3) for j in range(i, 3)]

    def central(d, h):
        ep = port(cfg.cell @ (torch.eye(3, dtype=torch.float64) + h * d).T)[0]
        em = port(cfg.cell @ (torch.eye(3, dtype=torch.float64) - h * d).T)[0]
        return float(ep - em) / (2 * h)

    for d in dirs:
        d = torch.as_tensor(d)
        fd = (4 * central(d, h / 2) - central(d, h)) / 3
        got = float((deps * d).sum()) if aniso else float(deps)
        assert abs(got - fd) <= 1e-5 * scale, (d, got, fd)


def test_3x3_helpers_match_linalg():
    g = torch.Generator().manual_seed(0)
    for scale in (1e-4, 0.3, 2.0, 40.0):
        a = torch.randn((5, 3, 3), generator=g, dtype=torch.float64) * scale
        sym = 0.5 * (a + a.transpose(1, 2))
        w, v = torch.linalg.eigh(sym)
        ref = (v * torch.exp(w)[:, None, :]) @ v.transpose(1, 2)
        got = expm_sym(sym)
        rel = ((got - ref).abs().amax((1, 2)) / ref.abs().amax((1, 2)))
        assert rel.max() <= 1e-12, (scale, rel.max())
        np.testing.assert_allclose(det3(a).numpy(), torch.linalg.det(a).numpy(),
                                   rtol=1e-12, atol=1e-12 * scale**3)
        np.testing.assert_allclose((inv3(a) @ a).numpy(),
                                   np.broadcast_to(np.eye(3), (5, 3, 3)),
                                   atol=1e-12)
    cell = torch.tensor([[3.6, 0.0, 0.0], [1.1, 3.4, 0.0], [0.3, 0.7, 3.9]],
                        dtype=torch.float64)
    widths = 1.0 / torch.linalg.norm(torch.linalg.inv(cell), dim=0)
    np.testing.assert_allclose(float(_min_perp_width(cell)),
                               float(widths.min()), rtol=1e-12)


def test_npt_uncertainty_trip_lands_on_the_same_step(trained_folder):
    """With the trip armed, both packages hand the same steps to the host
    calculator (the visits' step counts and positions agree)."""
    visits = {}
    finals = {}
    thresh = None
    for name in ("jax", "port"):
        jcalc, calc = calc_pair(trained_folder)
        c = jcalc if name == "jax" else calc
        s = system_pair(temperature=600)[0 if name == "jax" else 1]
        s.calc = c
        s.get_potential_energy()
        if thresh is None:
            thresh = float(np.max(c._host_beta())) * 1.03
        c.ediff = thresh
        cls = JaxDeviceNPT if name == "jax" else DeviceNPT
        dyn = cls(s, c, DT, temperature_K=600, pressure_GPa=0.0,
                  tdamp=50 * units.fs, pdamp=200 * units.fs, chunk=8,
                  check_beta=True, isotropic=True)
        seen = visits.setdefault(name, [])
        inner = c.calculate

        def calculate(system, inner=inner, seen=seen, dyn=dyn):
            seen.append((dyn.nsteps, system.positions.copy()))
            return inner(system)

        c.calculate = calculate
        dyn.run(16)
        finals[name] = (dyn.nsteps, s.positions.copy())
    jv, tv = visits["jax"], visits["port"]
    assert len(jv) >= 2, "the threshold never tripped"
    assert [k for k, _ in tv] == [k for k, _ in jv]
    for (_, a), (_, b) in zip(jv, tv):
        np.testing.assert_allclose(b, a, atol=1e-8)
    assert finals["port"][0] == finals["jax"][0] == 16
    np.testing.assert_allclose(finals["port"][1], finals["jax"][1], atol=1e-8)
