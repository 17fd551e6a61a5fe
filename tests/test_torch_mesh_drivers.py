"""The port's device drivers under a device mesh against the port's own
unsharded drivers (CPU, float64; the unsharded drivers are held against
the JAX package in tests/test_torch_{md,npt,opt,bcm,meta}.py):
``DeviceMD`` (Langevin, with the in-loop rebuild: each data shard
rebuilds its own rows), ``DeviceNPT`` (flexible cell, in-loop rebuild
under the moving cell), ``DeviceFIRE`` (fixed and variable cell),
``DeviceNEB`` (a cell per image), DeviceMD (Langevin, NHC) and DeviceNPT
on a mesh whose data axis pads the rows, a committee and the fused ActiveMeta
bias under a mesh, ``cl.md`` with ``mesh = make_mesh(...)`` in ARGS, a
BCM spawn keeping the mesh, ``mesh_bench`` at a tiny size, and the
``torch.profiler`` trace and spans of ``profiling``.  The meshes repeat
the ``cpu`` device; the Langevin noise is seeded per step, so a sharded
and an unsharded run draw the same numbers.

The model is the JAX package's own mesh tests' (tests/test_parallel.py
``build_state``: five inducing environments of rc = 3.2 A, lmax = nmax =
2), with a per-species uncertainty scale, written as a model folder; the
committee restarts from two such folders with different weights.  The
systems are rattled 32-atom Cu boxes (the 7.2 A box admits the device
rebuild at rc + skin = 3.5 A).

Tolerances: 1e-9 A (A/fs) for positions, velocities and cells after up to
24 steps (the sums of the shards run in other orders; the JAX package's
own mesh tests hold 1e-9 to 1e-10), 1e-10 relative for single
evaluations; step counts and breach reads are equal."""

import json
import os

import numpy as np
import pytest
import torch

from autoforce_tpu.io.model_io import save_model as jax_save_model
from autoforce_tpu_torch import units
from autoforce_tpu_torch.calculator import BCMActiveCalculator
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.meta import ActiveMeta
from autoforce_tpu_torch.md import device_md as dmd
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.md.device_npt import DeviceNPT
from autoforce_tpu_torch.opt.device_fire import DeviceFIRE
from autoforce_tpu_torch.opt.device_neb import DeviceNEB
from autoforce_tpu_torch.opt.neb import interpolate_images
from autoforce_tpu_torch.parallel import make_mesh
from autoforce_tpu_torch.parallel import mesh as pm
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_parallel import build_state
from test_torch_npt import count_breach_reads

F64 = dict(device="cpu", dtype=torch.float64)
FS = units.fs
MESHES = (None, (2, 2))


def mesh_of(shape):
    return None if shape is None else make_mesh(*shape, devices=["cpu"] * 8)


def _write(folder, mu_seed=None):
    eng, model, _ = build_state()
    model.vscale = {29: 1.0}
    if mu_seed is not None:
        model.mu = np.random.default_rng(mu_seed).normal(size=model.m)
    model._model_arrays = None
    jax_save_model(model, folder)
    return folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The frozen model folder (JAX package's mesh-test model)."""
    return _write(str(tmp_path_factory.mktemp("mesh") / "model.pckl"))


@pytest.fixture(scope="module")
def committee_dir(tmp_path_factory):
    """Two expert folders ``bcm_1.pckl`` (frozen) and ``bcm_2.pckl``
    (live) of the same inducing set with different weights."""
    d = tmp_path_factory.mktemp("bcm")
    _write(str(d / "bcm_1.pckl"))
    _write(str(d / "bcm_2.pckl"), mu_seed=7)
    return str(d)


def calc_of(folder, shape, skin=0.3):
    return ActiveCalculator(covariance=folder, calculator=None, logfile=None,
                            pckl=None, tape=None, skin=skin,
                            mesh=mesh_of(shape), **F64)


def cu_box(rattle=0.05, seed=9, temperature=None):
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(rattle, seed=seed)
    if temperature:
        maxwell_boltzmann_velocities(s, temperature, seed=3)
    return s


def both(run):
    """``run(shape)`` without and with the mesh."""
    return [run(shape) for shape in MESHES]


def test_device_md_inloop_rebuild_with_mesh(folder, monkeypatch):
    """Hot Langevin MD with a tight skin: every breach is served inside the
    chunks, each data shard rebuilding its own rows; same breaches, same
    trajectory."""
    reads = count_breach_reads(monkeypatch)

    def run(shape):
        reads.clear()
        calc = calc_of(folder, shape)
        s = cu_box(temperature=900)
        s.calc = calc
        dyn = DeviceMD(s, calc, dt=3 * FS, temperature_K=600, chunk=12,
                       seed=1, check_beta=False)
        assert dyn.in_loop_rebuild and (dyn.mesh is None) == (shape is None)
        dyn.run(24)
        assert dyn.nsteps == 24
        return s.positions.copy(), s.get_velocities().copy(), len(reads)

    (p0, v0, r0), (p1, v1, r1) = both(run)
    assert r0 == r1 > 0  # the 0.3 A skin was breached
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    np.testing.assert_allclose(v1, v0, atol=1e-9)


def test_device_npt_with_mesh(folder):
    def run(shape):
        calc = calc_of(folder, shape)
        s = cu_box(rattle=0.04, temperature=800)
        s.calc = calc
        dyn = DeviceNPT(s, calc, 2.5 * FS, temperature_K=500,
                        pressure_GPa=0.5, tdamp=50 * FS, pdamp=150 * FS,
                        chunk=10, check_beta=False, isotropic=False)
        dyn.run(20)
        assert dyn.nsteps == 20
        return s.positions.copy(), np.asarray(s.cell).copy(), dyn.vg.copy()

    (p0, c0, g0), (p1, c1, g1) = both(run)
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    np.testing.assert_allclose(c1, c0, atol=1e-11)
    np.testing.assert_allclose(g1, g0, atol=1e-12)
    assert np.abs(c1 - np.asarray(cu_box().cell)).max() > 1e-8


@pytest.mark.parametrize("driver", ["langevin", "npt"])
def test_sharded_chunks_carry_no_graph(folder, driver, monkeypatch):
    """After sharded DeviceMD / DeviceNPT chunks no tensor carried from one
    chunk iteration to the next (a chunk's outputs, a force evaluation's
    outputs, the driver's chain state) has a grad_fn or requires grad; and
    the tensor the shards copy is a view of the position leaf, not the
    leaf: the leaf's gradient then arrives from an op on its own device,
    never from the backward of a copy on another device (on distinct
    cards torch reports that as an AccumulateGrad stream mismatch)."""
    import autoforce_tpu_torch.md.device_npt as dnpt

    carried, handed = [], []
    chunk = dmd.md_chunk if driver == "langevin" else dnpt.md_chunk_npt
    module = dmd if driver == "langevin" else dnpt

    def recorded_chunk(*a, **k):
        out = chunk(*a, **k)
        carried.extend(out)
        return out

    make = pm._sharded_forces_fn if driver == "langevin" else \
        pm._sharded_forces_virial_fn
    name = make.__name__

    def recorded_make(*a, **k):
        fn = make(*a, **k)

        def forces_fn(*x, **y):
            out = fn(*x, **y)
            carried.extend(out)
            return out

        return forces_fn

    psum = pm._psum_energy

    def recorded_psum(sh, pos, *a, **k):
        handed.append(pos)
        return psum(sh, pos, *a, **k)

    monkeypatch.setattr(module, chunk.__name__, recorded_chunk)
    monkeypatch.setattr(pm, name, recorded_make)
    monkeypatch.setattr(pm, "_psum_energy", recorded_psum)
    calc = calc_of(folder, (2, 2))
    s = cu_box(rattle=0.04, temperature=800)
    s.calc = calc
    if driver == "npt":
        dyn = DeviceNPT(s, calc, 2.5 * FS, temperature_K=500,
                        pressure_GPa=0.5, tdamp=50 * FS, pdamp=150 * FS,
                        chunk=5, check_beta=False, isotropic=False)
    else:
        dyn = DeviceMD(s, calc, dt=3 * FS, temperature_K=600, chunk=5,
                       seed=1, check_beta=False, thermostat="nhc")
    dyn.run(15)
    assert dyn.nsteps == 15 and handed and carried

    def tensors(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)
        elif isinstance(x, dict):
            for y in x.values():
                yield from tensors(y)
        elif hasattr(x, "_fields"):
            yield from tensors(tuple(x))

    state = [vars(dyn)[k] for k in vars(dyn) if k != "system"]
    live = [x for x in tensors(carried + state)
            if x.requires_grad or x.grad_fn is not None]
    assert not live, [(tuple(x.shape), x.grad_fn) for x in live]
    # every sharded energy (the drivers' closures and the first predict):
    # the positions handed to the shards come from an op on the leaf's
    # device, whose input is the leaf
    for pos in handed:
        assert pos.grad_fn is not None, "the shards copy the leaf itself"
        leaves = [f for f, _ in pos.grad_fn.next_functions
                  if type(f).__name__ == "AccumulateGrad"]
        assert leaves and all(f.variable.device == pos.device
                              for f in leaves)


@pytest.mark.parametrize("driver", ["langevin", "nhc", "npt"])
def test_drivers_on_a_mesh_that_adds_rows(folder, driver, monkeypatch):
    """A 3 x 1 mesh pads the box's 32 rows to 33.  The padding row weighs
    1, as the chain's own padding does (at 0 its velocity became 0/0 =
    NaN, the skin test's NaN never tripped and the real atoms' breaches
    went unseen), draws no Langevin noise, and the hot run breaches its
    skin as often as the unsharded one and follows it."""
    reads = count_breach_reads(monkeypatch)

    def run(shape):
        reads.clear()
        calc = calc_of(folder, shape)
        s = cu_box(rattle=0.04, temperature=900)
        s.calc = calc
        if driver == "npt":
            dyn = DeviceNPT(s, calc, 2.5 * FS, temperature_K=500,
                            pressure_GPa=0.5, tdamp=50 * FS, pdamp=150 * FS,
                            chunk=10, check_beta=False, isotropic=False)
        else:
            dyn = DeviceMD(s, calc, dt=3 * FS, temperature_K=600, chunk=12,
                           seed=1, check_beta=False, thermostat=driver)
        dyn.run(24)
        assert dyn.nsteps == 24 and calc.cfg.npad == 32  # 33 on the mesh
        return (s.positions.copy(), s.get_velocities().copy(),
                np.asarray(s.cell).copy(), len(reads))

    (p0, v0, c0, r0), (p1, v1, c1, r1) = [run(shape)
                                          for shape in (None, (3, 1))]
    assert r0 == r1 > 0  # the 0.3 A skin was breached
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    np.testing.assert_allclose(v1, v0, atol=1e-9)
    np.testing.assert_allclose(c1, c0, atol=1e-11)


@pytest.mark.parametrize("cell", [False, True])
def test_device_fire_with_mesh(folder, cell):
    def run(shape):
        calc = calc_of(folder, shape)
        s = cu_box(rattle=0.2 if not cell else 0.05, seed=11)
        s.calc = calc
        dopt = DeviceFIRE(s, calc, dt=0.08, chunk=6, check_beta=False,
                          cell=cell, scalar_pressure=0.0)
        conv = dopt.run(fmax=1e-9, steps=15)
        return (s.positions.copy(), np.asarray(s.cell).copy(), dopt.nsteps,
                conv, dopt.fmax)

    r0, r1 = both(run)
    assert r0[2:4] == r1[2:4] and r1[2] == 15
    np.testing.assert_allclose(r1[0], r0[0], atol=1e-9)
    np.testing.assert_allclose(r1[1], r0[1], atol=1e-10)
    assert abs(r1[4] - r0[4]) <= 1e-10 * r0[4]
    assert np.abs(r1[0] - cu_box(0.2 if not cell else 0.05, 11).positions
                  ).max() > 1e-4


def test_device_neb_with_mesh_and_a_cell_per_image(folder):
    """The band's images stacked as rows, every image's atoms sharded alike
    (the image axis of the mesh), the last end strained 1 % along x."""

    def run(shape):
        calc = calc_of(folder, shape)
        first = cu_box()
        last = cu_box(rattle=0.05, seed=21)
        c = np.asarray(last.cell).copy()
        c[0] *= 1.01
        last.set_cell(c, scale_atoms=True)
        images = interpolate_images(first, last, 5)
        for im in images:
            im.calc = calc
        dopt = DeviceNEB(images, calc, k=0.1, dt=0.05, chunk=4,
                         check_beta=False)
        conv = dopt.run(fmax=0.05, steps=12)
        return np.stack([im.positions for im in images]), dopt.nsteps, conv

    (p0, n0, c0), (p1, n1, c1) = both(run)
    assert n0 == n1 == 12 and c0 == c1
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    assert np.abs(p1[2] - p0[0]).max() > 1e-4


def committee(committee_dir, shape):
    return BCMActiveCalculator(
        calculator=None, pckl=os.path.join(committee_dir, "bcm.pckl"),
        logfile=None, kernel_kw=dict(cutoff=3.2, lmax=2, nmax=2),
        mesh=mesh_of(shape), **F64)


def test_committee_under_a_mesh(committee_dir):
    """A two-expert committee: one sharded evaluation against the unsharded
    one (energy, forces and the committee floor that trips sampling), and
    DeviceMD on it."""
    calc = committee(committee_dir, None)
    s = cu_box()
    s.calc = calc
    s.get_potential_energy()
    chain = dmd.new_chain(calc, s, True)
    assert chain["mean_e"] is not None
    want = dmd._sgpr_forces(chain["cfg"].positions, chain["cfg"], chain["ma"],
                            chain["radii"], chain["vs"], calc.engine.params,
                            calc.engine.exponent, True, chain["ks"],
                            chain["mean_e"])
    mesh = mesh_of((2, 2))
    ch = pm.pad_chain(chain, mesh)
    got = pm.mesh_chunk(ch["cfg"], ch["ma"], ch["radii"], ch["vs"],
                        ch["oidx"], mesh, calc.engine.params,
                        calc.engine.exponent, True, ch["ks"],
                        ch["mean_e"]).forces_fn(ch["cfg"].positions)
    assert abs(float(got[0] - want[0])) <= 1e-10 * abs(float(want[0]))
    n = len(s)
    fmax = want[1].abs().max()
    assert (got[1][:n] - want[1][:n]).abs().max() <= 1e-10 * fmax
    assert abs(float(got[2] - want[2])) <= 1e-10 and float(want[2]) > 0

    def run(shape):
        calc = committee(committee_dir, shape)
        s = cu_box(temperature=400)
        s.calc = calc
        dyn = DeviceMD(s, calc, dt=2 * FS, temperature_K=400, chunk=6,
                       seed=2, check_beta=False)
        dyn.run(12)
        return s.positions.copy()

    p0, p1 = both(run)
    np.testing.assert_allclose(p1, p0, atol=1e-9)


def test_committee_band_under_a_mesh(committee_dir):
    """The committee's expert axis and the band's image axis together: its
    weights taken per image over every shard's atoms."""

    def run(shape):
        calc = committee(committee_dir, shape)
        first = cu_box()
        last = cu_box(rattle=0.05, seed=21)
        images = interpolate_images(first, last, 4)
        for im in images:
            im.calc = calc
        dopt = DeviceNEB(images, calc, k=0.1, dt=0.05, chunk=4,
                         check_beta=False)
        dopt.run(fmax=0.05, steps=8)
        return np.stack([im.positions for im in images]), dopt.nsteps

    (p0, n0), (p1, n1) = both(run)
    assert n0 == n1 == 8
    np.testing.assert_allclose(p1, p0, atol=1e-9)


def test_active_meta_under_a_mesh(folder):
    """The ActiveMeta bias fused into the sharded MD step (its covariance
    rows gathered over the model axis inside the differentiated energy)
    bends the trajectory as the unsharded step does."""

    def run(shape, meta=True):
        calc = calc_of(folder, shape)
        if meta:
            calc.meta = ActiveMeta(scale=0.05)
        s = cu_box(temperature=400)
        s.calc = calc
        DeviceMD(s, calc, dt=2 * FS, chunk=5, seed=1, check_beta=False,
                 thermostat="none").run(10)
        return s.positions.copy()

    p0, p1 = both(run)
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    assert np.abs(run(None, meta=False) - p1).max() > 1e-7


def test_cl_md_with_a_mesh_in_args(folder, tmp_path, monkeypatch):
    """``cl.md`` with ``mesh = make_mesh(...)`` in ARGS: the device
    dynamics run sharded and write the frames of the run without it."""
    import autoforce_tpu_torch.cl as cl
    import autoforce_tpu_torch.cl.md as cl_md
    from autoforce_tpu_torch.io.xyz import read_xyz

    monkeypatch.setattr(cl_md, "maxwell_boltzmann_velocities",
                        lambda s, t, **kw: maxwell_boltzmann_velocities(
                            s, t, seed=7))
    frames = {}
    for name, extra in (("plain", ""), ("mesh", "mesh = make_mesh(data=2, "
                                        "model=2, devices=['cpu'] * 4)\n")):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        args = dict(covariance=folder, calculator=None, calc_device="cpu",
                    dtype="float64", pckl=None, tape=None, logfile=None)
        (d / "ARGS").write_text("".join(f"{k} = {v!r}\n"
                                        for k, v in args.items()) + extra)
        cl.refresh()
        assert (cl.ARGS.get("mesh") is None) == (name == "plain")
        kwargs = cl.get_default_args(cl_md.md)
        cl.update_args(kwargs)
        kwargs.update(dynamics="DEVICE", tem=300.0, dt=2.0, picos=-30,
                      loginterval=10, trajectory="md.extxyz")
        s = cu_box()
        cl_md.md(s, **kwargs)
        frames[name] = read_xyz("md.extxyz")
    assert len(frames["mesh"]) == len(frames["plain"]) > 1
    for a, b in zip(frames["plain"], frames["mesh"]):
        np.testing.assert_allclose(b.positions, a.positions, atol=1e-9)


def test_spawned_expert_and_clone_keep_the_mesh(folder):
    calc = calc_of(folder, (2, 2))
    eng = calc.engine
    assert eng.mesh is calc.mesh and eng.clone_config().mesh is eng.mesh
    cfg = eng.make_config(cu_box())
    assert cfg.nbr_rev is None  # no reverse slots under a mesh


def test_mesh_bench_at_a_tiny_size(capsys):
    from autoforce_tpu_torch.parallel import mesh_bench as mb

    model = mb.synthetic_model("cpu", torch.float64, lmax=2, nmax=2, m=8)
    res = mb.measure(model=model, n_data=2, n_model=2, steps=4,
                     check_beta=True, device="cpu", dtype=torch.float64,
                     natoms=32)
    mb.report(res)
    out = capsys.readouterr().out
    assert "mesh_bench: devices=4 mesh=(2x2)" in out and "psum_forces" in out
    assert res["dpos_max"] < 1e-10
    b = res["bytes_per_step"]
    assert b["psum_forces"] == 32 * 3 * 8 and b["pmax_beta"] == 16


def test_profiling_trace_and_spans(tmp_path):
    from autoforce_tpu_torch.profiling import span, trace

    with trace(str(tmp_path / "tr"), cuda=False) as prof:
        with span("af.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in k.key for k in prof.key_averages())
    step = [e for e in events if e.get("name") == "af.step"]
    assert len(step) == 1 and step[0]["cat"] == "user_annotation"
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert step[0]["ts"] <= mm[0]["ts"] <= step[0]["ts"] + step[0]["dur"]
