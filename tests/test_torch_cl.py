"""The port's command line (``autoforce_tpu_torch.cl``) against the JAX
package's on the same ARGS file (CPU, float64): ``cl.md`` with the device
integrator (Nose-Hoover NVT, a two-walker ensemble with ``replicas = 2``,
and MTK NPT with ``bulk_modulus``),
``cl.relax`` with ``algo='DEVICE'`` and ``cell=True``, and ``cl.neb`` with
``device=True``, each in a temporary directory with the EMT oracle named
in ARGS and the trained 32-atom Cu model of tests/test_torch_npt.py.  The
sampling thresholds are set out of reach so that both runs stay on the
frozen model (the oracle is loaded, and called only where the command
asks for an exact check).  Then the refusal of a mesh with more devices
than the machine has (the mesh itself runs in
tests/test_torch_mesh_drivers.py); the oracle names that resolve now are
held in tests/test_torch_oracle_io.py.

Tolerances: 1e-8 A for positions and cells, 1e-8 eV for energies."""

import os

import numpy as np
import pytest

import autoforce_tpu.cl as jax_cl
import autoforce_tpu.cl.md as jax_cl_md
import autoforce_tpu_torch.cl as cl
import autoforce_tpu_torch.cl.md as cl_md
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities as jax_mb
from autoforce_tpu_torch.io.xyz import read_xyz
from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

from test_torch_npt import trained_folder  # noqa: F401 (fixture)


def write_args(path, **kw):
    with open(os.path.join(path, "ARGS"), "w") as f:
        for k, v in kw.items():
            f.write(f"{k} = {v!r}\n")


def frozen_args(folder, **kw):
    """ARGS serving ``folder`` under the EMT oracle, with thresholds no
    configuration here reaches."""
    return dict(covariance=folder, calculator="EMT", calc_device="cpu",
                dtype="float64", pckl=None, tape=None, logfile=None,
                ediff=1e6, ediff_tot=1e6, fdiff=1e6, **kw)


def run_both(tmp_path, monkeypatch, args, fn):
    """``fn(pkg)`` in one directory per package, each after reading the
    same ARGS; returns the frames each wrote (``fn``'s file name)."""
    out = {}
    for name, mod in (("jax", jax_cl), ("port", cl)):
        d = tmp_path / name
        d.mkdir()
        write_args(str(d), **args)
        monkeypatch.chdir(d)
        mod.refresh()
        out[name] = fn(name)
    return out


def seeded_mb(pkg_mb):
    # cl.md draws its velocities unseeded; both packages get the same seed
    return lambda system, t, **kw: pkg_mb(system, t, seed=7)


def cu_box(name, a=3.6):
    s = (jax_bulk_fcc if name == "jax" else bulk_fcc)("Cu", a).repeat((2, 2, 2))
    s.rattle(0.05, seed=11)
    return s


def assert_frames_equal(fa, fb):
    assert len(fa) == len(fb) > 0
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(b.positions, a.positions, atol=1e-8)
        np.testing.assert_allclose(np.asarray(b.cell), np.asarray(a.cell),
                                   atol=1e-8)
        np.testing.assert_allclose(b.get_potential_energy(),
                                   a.get_potential_energy(), atol=1e-8)


@pytest.mark.parametrize("ensemble", ["nvt", "npt"])
def test_cl_md_device_matches_jax(trained_folder, tmp_path,  # noqa: F811
                                  monkeypatch, ensemble):
    monkeypatch.setattr(jax_cl_md, "maxwell_boltzmann_velocities",
                        seeded_mb(jax_mb))
    monkeypatch.setattr(cl_md, "maxwell_boltzmann_velocities",
                        seeded_mb(maxwell_boltzmann_velocities))
    extra = dict(bulk_modulus=140.0) if ensemble == "npt" else {}
    args = frozen_args(trained_folder, thermostat="nhc", eps_pos=0.0,
                       **extra)

    def fn(name):
        mod = jax_cl_md if name == "jax" else cl_md
        kwargs = (jax_cl if name == "jax" else cl).get_default_args(mod.md)
        (jax_cl if name == "jax" else cl).update_args(kwargs)
        kwargs.update(dynamics="DEVICE", tem=300.0, dt=2.0, picos=-50,
                      loginterval=25, trajectory="md.extxyz")
        atoms = cu_box(name)
        mod.md(atoms, **kwargs)
        return read_xyz("md.extxyz")

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_frames_equal(out["jax"], out["port"])
    if ensemble == "npt":
        assert not np.allclose(np.asarray(out["port"][-1].cell),
                               np.asarray(cu_box("port").cell))


def test_cl_relax_device_cell_matches_jax(trained_folder, tmp_path,  # noqa: F811
                                          monkeypatch):
    import autoforce_tpu.cl.relax as jax_relax
    import autoforce_tpu_torch.cl.relax as relax

    args = frozen_args(trained_folder, algo="DEVICE", cell=True, fmax=0.05)

    def fn(name):
        mod = jax_relax if name == "jax" else relax
        pkg = jax_cl if name == "jax" else cl
        kwargs = pkg.get_default_args(mod.relax)
        pkg.update_args(kwargs)
        atoms = cu_box(name, a=3.65)
        mod.relax(atoms, **kwargs)
        return read_xyz("relax.extxyz")

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_frames_equal(out["jax"], out["port"])
    f = out["port"][-1].get_forces()
    assert np.sqrt((f * f).sum(1).max()) < 0.05


def test_cl_neb_device_matches_jax(trained_folder, tmp_path,  # noqa: F811
                                   monkeypatch):
    """A vacancy hop in the 32-atom box: end points relaxed by LBFGS, five
    images relaxed by the device NEB with the climbing image."""
    import autoforce_tpu.cl.neb as jax_neb
    import autoforce_tpu_torch.cl.neb as neb

    args = frozen_args(trained_folder, nimages=5, fmax=0.1, device=True)

    def fn(name):
        mod = jax_neb if name == "jax" else neb
        pkg = jax_cl if name == "jax" else cl
        kwargs = pkg.get_default_args(mod.neb)
        pkg.update_args(kwargs)
        a = cu_box(name)
        first = a.permuted(np.arange(1, len(a)))  # atom 0 leaves a hole
        last = first.copy()
        pos = last.positions.copy()
        # the hole's nearest neighbor hops into it
        d = np.linalg.norm(a.positions[1:] - a.positions[0], axis=1)
        pos[d.argmin()] = a.positions[0]
        last.set_positions(pos)
        band = mod.neb([first, last], **kwargs)
        return read_xyz("neb.extxyz"), band.barrier()

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_frames_equal(out["jax"][0], out["port"][0])
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-8)
    assert out["port"][1] > 0


@pytest.mark.parametrize("line,what", [
    ("mesh = make_mesh(data=8)", "mesh"),
])
def test_cl_refuses_what_is_not_ported(tmp_path, monkeypatch, line, what):
    # the mesh is ported: ARGS' make_mesh refuses a mesh of more cards than
    # the machine has (its default devices are the cards, never the CPU)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ARGS").write_text(line + "\n")
    with pytest.raises(ValueError, match=f"{what} 8x1 needs 8 devices, have 1"):
        cl.refresh()


def test_cl_md_replicas_matches_jax(trained_folder, tmp_path,  # noqa: F811
                                   monkeypatch):
    """``replicas = 2``: a two-walker ensemble (walker 1 a rattled,
    re-thermalized copy), walker 0's frames on the trajectory."""
    monkeypatch.setattr(jax_cl_md, "maxwell_boltzmann_velocities",
                        seeded_mb(jax_mb))
    monkeypatch.setattr(cl_md, "maxwell_boltzmann_velocities",
                        seeded_mb(maxwell_boltzmann_velocities))
    args = frozen_args(trained_folder, thermostat="nhc", eps_pos=0.0,
                       replicas=2)

    def fn(name):
        mod = jax_cl_md if name == "jax" else cl_md
        kwargs = (jax_cl if name == "jax" else cl).get_default_args(mod.md)
        (jax_cl if name == "jax" else cl).update_args(kwargs)
        assert kwargs["replicas"] == 2
        kwargs.update(dynamics="DEVICE", tem=300.0, dt=2.0, picos=-50,
                      loginterval=25, trajectory="md.extxyz")
        mod.md(cu_box(name), **kwargs)
        return read_xyz("md.extxyz")

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_frames_equal(out["jax"], out["port"])
    assert not np.allclose(out["port"][-1].positions,
                           out["port"][0].positions)
