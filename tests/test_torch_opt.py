"""The port's relaxation drivers against the JAX package (CPU, float64):
``DeviceFIRE`` with a fixed and a variable cell, ``DeviceNEB`` with and
without the climbing image, the host optimizers and thermostats copied
into the port, and an uncertainty trip under FIRE and NEB.

The model and the workloads are the JAX package's own device FIRE / NEB
tests' (tests/test_device_fire.py, tests/test_device_neb.py: a frozen
model fitted to Lennard-Jones data, 32-atom Cu boxes), so that the same
FIRE branches are taken; the model is written once as a folder and loaded
by both packages.

Tolerances: 1e-8 A for positions and cells (1e-10 over the short
host-tracking horizons, as the JAX tests), 1e-12 relative for the FIRE
clock, 1e-8 eV for barriers; iteration counts are equal."""

import numpy as np
import pytest
import torch

from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.io.model_io import save_model
from autoforce_tpu.md import MTKNPT as JaxMTKNPT
from autoforce_tpu.md import NoseHooverNVT as JaxNoseHooverNVT
from autoforce_tpu.opt import FIRE as JaxFIRE
from autoforce_tpu.opt import LBFGS as JaxLBFGS
from autoforce_tpu.opt import NEB as JaxNEB
from autoforce_tpu.opt import UnitCellFilter as JaxUnitCellFilter
from autoforce_tpu.opt.device_fire import DeviceFIRE as JaxDeviceFIRE
from autoforce_tpu.opt.device_neb import DeviceNEB as JaxDeviceNEB
from autoforce_tpu.opt.neb import interpolate_images as jax_interpolate
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.md import MTKNPT, NoseHooverNVT
from autoforce_tpu_torch.opt import FIRE, LBFGS, NEB, UnitCellFilter
from autoforce_tpu_torch.opt.device_fire import DeviceFIRE
from autoforce_tpu_torch.opt.device_neb import DeviceNEB
from autoforce_tpu_torch.opt.neb import interpolate_images
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_device_fire import _frozen_calc
from test_torch_npt import count_breach_reads

JAX = dict(fcc=jax_bulk_fcc, calc=JaxCalc, FIRE=JaxFIRE, LBFGS=JaxLBFGS,
           NEB=JaxNEB, UnitCellFilter=JaxUnitCellFilter,
           DeviceFIRE=JaxDeviceFIRE, DeviceNEB=JaxDeviceNEB,
           interpolate=jax_interpolate, mb=jax_mb, MTKNPT=JaxMTKNPT,
           NoseHooverNVT=JaxNoseHooverNVT)
PORT = dict(fcc=bulk_fcc, calc=ActiveCalculator, FIRE=FIRE, LBFGS=LBFGS,
            NEB=NEB, UnitCellFilter=UnitCellFilter, DeviceFIRE=DeviceFIRE,
            DeviceNEB=DeviceNEB, interpolate=interpolate_images,
            mb=maxwell_boltzmann_velocities, MTKNPT=MTKNPT,
            NoseHooverNVT=NoseHooverNVT)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The JAX device FIRE tests' frozen model, as a model folder."""
    path = str(tmp_path_factory.mktemp("frozen") / "model.pckl")
    save_model(_frozen_calc().model, path)
    return path


def make_calc(pkg, folder, skin):
    kw = dict(covariance=folder, calculator=None, logfile=None, pckl=None,
              tape=None, skin=skin)
    if pkg is PORT:
        kw.update(device="cpu", dtype=torch.float64)
    return pkg["calc"](**kw)


def box(pkg, calc, a=3.6, rattle=0.12, seed=5):
    s = pkg["fcc"]("Cu", a).repeat((2, 2, 2))
    s.rattle(rattle, seed=seed)
    s.calc = calc
    return s


def band(pkg, calc, nimages=5):
    ends = []
    for seed in (1, 2):
        s = pkg["fcc"]("Cu", 3.6).repeat((2, 2, 2))
        s.rattle(0.10, seed=seed)
        s.calc = calc
        ends.append(s)
    images = pkg["interpolate"](ends[0], ends[1], nimages)
    for im in images:
        im.calc = calc
    return images


@pytest.mark.parametrize("cell", [False, True])
def test_device_fire_matches_jax_and_host(folder, cell):
    a, rattle, seed = (3.65, 0.06, 4) if cell else (3.6, 0.12, 5)
    # 12 steps against the port's host FIRE (+ UnitCellFilter)
    calc = make_calc(PORT, folder, 0.8)
    host = box(PORT, calc, a, rattle, seed)
    target = UnitCellFilter(host) if cell else host
    opt = FIRE(target, dt=0.05)
    for _ in range(12):
        opt.step(target.get_forces())
        opt.nsteps += 1
    dev = box(PORT, calc, a, rattle, seed)
    dopt = DeviceFIRE(dev, calc, dt=0.05, chunk=5, check_beta=False,
                      cell=cell)
    dopt.run(fmax=1e-9, steps=12)
    assert dopt.nsteps == 12
    np.testing.assert_allclose(dev.positions, host.positions, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dev.cell), np.asarray(host.cell),
                               atol=1e-10)
    np.testing.assert_allclose(dopt.dt_cur, opt.dt, rtol=1e-12)
    np.testing.assert_allclose(dopt.a, opt.a, rtol=1e-12)
    assert int(dopt.n_uphill) == opt.n_uphill
    if cell:
        np.testing.assert_allclose(dopt.deform, target.deform, atol=1e-12)
    # whole relaxations: the JAX package's device FIRE, same iterations
    out = {}
    for pkg in (JAX, PORT):
        c = make_calc(pkg, folder, 0.8)
        s = box(pkg, c, a, rattle, seed)
        d = pkg["DeviceFIRE"](s, c, dt=0.05, chunk=50, check_beta=False,
                              cell=cell)
        conv = d.run(fmax=0.02, steps=300)
        out[id(pkg)] = (conv, d.nsteps, s.positions.copy(),
                        np.asarray(s.cell).copy(), s.get_potential_energy())
    j, t = out[id(JAX)], out[id(PORT)]
    assert j[0] and t[0]
    assert t[1] == j[1]
    np.testing.assert_allclose(t[2], j[2], atol=1e-8)
    np.testing.assert_allclose(t[3], j[3], atol=1e-8)
    np.testing.assert_allclose(t[4], j[4], atol=1e-8)


def test_device_fire_chunked_matches_one_shot(folder):
    calc = make_calc(PORT, folder, 0.3)
    results = []
    for chunk in (64, 7):
        s = box(PORT, calc)
        d = DeviceFIRE(s, calc, dt=0.05, chunk=chunk, check_beta=False)
        d.run(fmax=0.02, steps=64)
        results.append((s.positions.copy(), d.nsteps))
    np.testing.assert_allclose(results[0][0], results[1][0], atol=1e-9)
    assert results[0][1] == results[1][1]


def test_device_fire_cell_inloop_rebuild_matches_jax(folder, monkeypatch):
    """A small skin under a relaxing cell: breaches are served by the
    in-loop (positions + cell) rebuild in both packages."""
    reads = count_breach_reads(monkeypatch)
    out = {}
    for pkg in (JAX, PORT):
        c = make_calc(pkg, folder, 0.10)
        s = box(pkg, c, a=3.52, rattle=0.05, seed=6)
        d = pkg["DeviceFIRE"](s, c, dt=0.05, chunk=30, check_beta=False,
                              cell=True)
        conv = d.run(fmax=0.03, steps=400)
        out[id(pkg)] = (conv, d.nsteps, s.positions.copy(),
                        np.asarray(s.cell).copy(), c.step)
    j, t = out[id(JAX)], out[id(PORT)]
    assert j[0] and t[0] and t[1] == j[1]
    np.testing.assert_allclose(t[2], j[2], atol=1e-8)
    np.testing.assert_allclose(t[3], j[3], atol=1e-8)
    start = np.asarray(bulk_fcc("Cu", 3.52).repeat((2, 2, 2)).cell)
    assert np.abs(t[3] - start).max() > 5e-3
    # breaches happened and were served in the loop, not by host visits
    assert len(reads) >= 2 and t[4] <= 2, (len(reads), t[4])


@pytest.mark.parametrize("climb", [False, True])
def test_device_neb_matches_jax_and_host(folder, climb):
    calc = make_calc(PORT, folder, 0.8)
    images_h = band(PORT, calc)
    nb = NEB(images_h, k=0.1, climb=climb)
    opt = FIRE(nb, dt=0.05, maxstep=0.1)
    for _ in range(10):
        opt.step(nb.get_forces())
        opt.nsteps += 1
    images_d = band(PORT, calc)
    d = DeviceNEB(images_d, calc, k=0.1, climb=climb, dt=0.05, maxstep=0.1,
                  chunk=4, check_beta=False)
    d.run(fmax=1e-9, steps=10)
    assert d.nsteps == 10
    for h, x in zip(images_h, images_d):
        np.testing.assert_allclose(x.positions, h.positions, atol=1e-9)
    np.testing.assert_allclose(d.dt_cur, opt.dt, rtol=1e-12)
    assert int(d.n_uphill) == opt.n_uphill
    # whole relaxations against the JAX package's device NEB
    out = {}
    for pkg in (JAX, PORT):
        c = make_calc(pkg, folder, 0.8)
        images = band(pkg, c)
        dn = pkg["DeviceNEB"](images, c, k=0.1, climb=climb, dt=0.05,
                              maxstep=0.1, chunk=50, check_beta=False)
        conv = dn.run(fmax=0.05, steps=300)
        out[id(pkg)] = (conv, dn.nsteps, [im.positions.copy() for im in images],
                        dn.barrier())
    j, t = out[id(JAX)], out[id(PORT)]
    assert j[0] and t[0] and t[1] == j[1]
    for a, b in zip(j[2], t[2]):
        np.testing.assert_allclose(b, a, atol=1e-8)
    np.testing.assert_allclose(t[3], j[3], atol=1e-8)
    ref = band(PORT, calc)
    np.testing.assert_allclose(images_d[0].positions, ref[0].positions,
                               atol=1e-12)


def cell_band(pkg, calc, nimages=5, strain=0.02):
    """A band whose images differ in cell: the last end point's cell
    stretched along x (its atoms scaled with it), each image's cell and
    fractional coordinates interpolated between the ends."""
    first, last = band(pkg, calc, 2)
    cell = np.asarray(last.cell).copy()
    cell[:, 0] *= 1.0 + strain
    last.set_cell(cell, scale_atoms=True)
    f0, f1 = first.scaled_positions(), last.scaled_positions()
    c0, c1 = np.asarray(first.cell), np.asarray(last.cell)
    images = []
    for k in range(nimages):
        t = k / (nimages - 1)
        im = first.copy()
        c = (1 - t) * c0 + t * c1
        im.set_cell(c)
        im.set_positions(((1 - t) * f0 + t * f1) @ c)
        im.calc = calc
        images.append(im)
    return images


def test_device_neb_images_with_their_own_cells_match_jax(folder):
    """A band whose interior images carry different cells: each stacked
    row keeps its image's cell, so the port's device NEB tracks the JAX
    package's, which builds one configuration per image."""
    out = {}
    for pkg in (JAX, PORT):
        c = make_calc(pkg, folder, 0.8)
        images = cell_band(pkg, c)
        assert len({float(im.cell[0, 0]) for im in images}) == len(images)
        d = pkg["DeviceNEB"](images, c, k=0.1, climb=True, dt=0.05,
                             maxstep=0.1, chunk=4, check_beta=False)
        d.run(fmax=1e-9, steps=8)
        assert d.nsteps == 8
        out[id(pkg)] = ([im.positions.copy() for im in images], d.dt_cur,
                        [im.get_potential_energy() for im in images])
    j, t = out[id(JAX)], out[id(PORT)]
    for a, b in zip(j[0], t[0]):
        np.testing.assert_allclose(b, a, atol=1e-9)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-12)
    np.testing.assert_allclose(t[2], j[2], atol=1e-9)


def test_stacked_band_with_a_cell_per_image_matches_each_image(folder):
    """The stacked rows of a band whose images differ in cell against each
    image evaluated alone, and a single-cell band's stacked rows under
    one (3, 3) cell against the same rows with a cell per row (float64)."""
    from autoforce_tpu_torch.opt.device_neb import band_forces, stack_images

    calc = make_calc(PORT, folder, 0.8)
    eng = calc.engine
    for images in (cell_band(PORT, calc), band(PORT, calc)):
        d = DeviceNEB(images, calc, k=0.1, check_beta=False)
        ch = d._build_chain()
        cfg, ma, radii, vs = ch["cfg"], ch["ma"], ch["radii"], ch["vs"]
        assert cfg.cell.shape == (cfg.npad, 3, 3)
        pos = ch["pos"][1:-1]
        args = (eng.params, eng.exponent, True, ch["ks"])
        e, f, b = band_forces(pos, cfg, ma, radii, vs, *args)
        n = pos.shape[1]
        for r, one in enumerate(ch["interior"]):
            e1, f1, b1 = band_forces(one.positions[None], one, ma, radii,
                                     vs[r * n:(r + 1) * n], *args)
            np.testing.assert_allclose(e[r].item(), e1.item(), atol=1e-10)
            np.testing.assert_allclose(f[r].numpy(), f1[0].numpy(),
                                       atol=1e-10)
            np.testing.assert_allclose(b[r].item(), b1.item(), atol=1e-10)
    # one cell for all rows, as the band stacked them before: the same bits
    one_cell = cfg._replace(cell=ch["interior"][0].cell)
    e0, f0, _ = band_forces(pos, one_cell, ma, radii, vs, *args)
    assert torch.equal(e0, e) and torch.equal(f0, f)


def _trip_visits(pkg, folder, make_driver, run, thresh):
    """Host calculator visits (driver step count, positions) of a run with
    the uncertainty trip armed at ``thresh``."""
    c = make_calc(pkg, folder, 0.8)
    c.ediff = thresh
    drv, systems = make_driver(pkg, c)
    seen = []
    inner = c.calculate

    def calculate(system):
        seen.append((drv.nsteps, system.positions.copy()))
        return inner(system)

    c.calculate = calculate
    run(drv)
    return seen, drv.nsteps, [s.positions.copy() for s in systems]


def _first_beta(folder, systems_of):
    c = make_calc(JAX, folder, 0.8)
    betas = []
    for s in systems_of(JAX, c):
        s.get_potential_energy()
        betas.append(float(np.max(c._host_beta())))
    return max(betas)


@pytest.mark.parametrize("driver", ["fire", "neb"])
def test_uncertainty_trip_lands_on_the_same_step(folder, driver):
    if driver == "fire":
        def systems_of(pkg, c):
            return [box(pkg, c)]

        def make_driver(pkg, c):
            s = box(pkg, c)
            return pkg["DeviceFIRE"](s, c, dt=0.05, chunk=8,
                                     check_beta=True), [s]

        def run(drv):
            drv.run(fmax=1e-9, steps=20)
    else:
        def systems_of(pkg, c):
            return band(pkg, c)[1:-1]

        def make_driver(pkg, c):
            images = band(pkg, c)
            return pkg["DeviceNEB"](images, c, k=0.1, dt=0.05, maxstep=0.1,
                                    chunk=8, check_beta=True), images

        def run(drv):
            drv.run(fmax=1e-9, steps=20)
    # a threshold a little above the starting uncertainty: the relaxation
    # moves the atoms into less known environments and trips it
    thresh = 1.02 * _first_beta(folder, systems_of)
    jv, jn, jpos = _trip_visits(JAX, folder, make_driver, run, thresh)
    tv, tn, tpos = _trip_visits(PORT, folder, make_driver, run, thresh)
    assert len(jv) > (1 if driver == "fire" else 5), "no trip"
    assert [k for k, _ in tv] == [k for k, _ in jv]
    for (_, a), (_, b) in zip(jv, tv):
        np.testing.assert_allclose(b, a, atol=1e-8)
    assert tn == jn == 20
    for a, b in zip(jpos, tpos):
        np.testing.assert_allclose(b, a, atol=1e-8)


def _host_run(pkg, folder, kind):
    c = make_calc(pkg, folder, 0.8)
    if kind == "neb":
        images = band(pkg, c)
        pkg["FIRE"](pkg["NEB"](images, k=0.1, climb=True), dt=0.05,
                    maxstep=0.1).run(fmax=0.05, steps=15)
        return np.concatenate([im.positions for im in images])
    s = box(pkg, c)
    if kind in ("nvt", "npt"):
        pkg["mb"](s, 300, seed=3)
        if kind == "nvt":
            drv = pkg["NoseHooverNVT"](s, 2 * units.fs, 300,
                                       tdamp=50 * units.fs)
        else:
            drv = pkg["MTKNPT"](s, 2 * units.fs, 300, pressure_GPa=0.3,
                                tdamp=50 * units.fs, pdamp=200 * units.fs,
                                mask=(1, 1, 0))
        drv.run(10)
        return np.concatenate([s.positions, s.get_velocities(),
                               np.asarray(s.cell)])
    target = pkg["UnitCellFilter"](s) if kind == "cell" else s
    opt = pkg["LBFGS" if kind == "lbfgs" else "FIRE"](target)
    opt.run(fmax=0.05, steps=15)
    return np.concatenate([s.positions, np.asarray(s.cell)])


@pytest.mark.parametrize("kind", ["fire", "lbfgs", "cell", "neb", "nvt",
                                  "npt"])
def test_host_drivers_match_jax(folder, kind):
    """The host FIRE, LBFGS, UnitCellFilter, NEB, NoseHooverNVT and MTKNPT
    copied into the port follow the JAX package's on its calculator."""
    np.testing.assert_allclose(_host_run(PORT, folder, kind),
                               _host_run(JAX, folder, kind), atol=1e-8)
