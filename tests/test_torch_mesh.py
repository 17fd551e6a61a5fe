"""The port's device mesh (``autoforce_tpu_torch.parallel``) against the JAX
package's sharded functions (CPU, float64): ``Engine.predict`` under a mesh
(``sharded_predict``) at three mesh shapes for the default, pair-term,
chemical and rbf kernels, ``kernel_block`` on both routes
(``sharded_kernel_block`` / ``sharded_kernel_block_jac``), NVE and NHC
``md_chunk(mesh=...)`` against the JAX package's ``sharded_md_chunk``
with and without the in-loop rebuild, a band relaxed by ``DeviceNEB``
under a mesh (``neb_chunk(mesh=...)``, JAX's ``sharded_neb_chunk``), and
``ActiveCalculator(mesh=...)`` learning.  The port's meshes repeat the
``cpu`` device; the JAX package's are the conftest's eight virtual CPU
devices.  Then the port alone: ``make_mesh`` and its refusals, the
unsharded path bit for bit as it was, and the launches of a sharded step.

The model is the JAX package's own mesh tests' (tests/test_parallel.py
``build_state``: five inducing environments of rc = 3.2 A, lmax = nmax =
2, random weights and a ridge-regularised choli), carried into the port
with ``io.convert.sgpr_model_from_jax``, on a rattled 32-atom Cu box.

Tolerances: 1e-10 relative to the largest value of each output (both
packages sum the same float64 terms in other orders); sampling decisions
and step counts are equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.opt.device_neb import DeviceNEB as JaxDeviceNEB
from autoforce_tpu.opt.neb import interpolate_images as jax_interpolate
from autoforce_tpu.parallel.mesh import make_mesh as jax_make_mesh
from autoforce_tpu.parallel.mesh import mesh_pad as jax_mesh_pad
from autoforce_tpu.parallel.mesh import sharded_md_chunk as jax_sharded_md
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.engine import (Engine, _columns, _stack_rows,
                                        _total_cov, gram, kernel_block_fn)
from autoforce_tpu_torch.io.convert import config_from_numpy, sgpr_model_from_jax
from autoforce_tpu_torch.md.device_md import md_chunk
from autoforce_tpu_torch.opt.device_neb import DeviceNEB
from autoforce_tpu_torch.opt.neb import interpolate_images
from autoforce_tpu_torch.parallel import Mesh, make_mesh
from autoforce_tpu_torch.parallel import mesh as pm
from autoforce_tpu_torch.system import bulk_fcc

from test_parallel import build_state

F64 = dict(device="cpu", dtype=torch.float64)
CPU8 = ["cpu"] * 8
REL = 1e-10


def port_mesh(shape):
    return make_mesh(*shape, devices=CPU8)


def box(fcc=jax_bulk_fcc, seed=9):
    s = fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=seed)
    return s


def close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def carry(cfg):
    return config_from_numpy(*(None if a is None else np.asarray(a)
                               for a in cfg), **F64)


@pytest.fixture(scope="module", params=["default", "pair", "chemical", "rbf"])
def state(request):
    """(JAX engine, model arrays, config; port engine, model arrays,
    config) of one kernel variant."""
    eng, model, _ = build_state(request.param)
    tmodel = sgpr_model_from_jax(model, **F64)
    cfg = eng.make_config(box())
    return (eng, model.full_model_arrays(), cfg, tmodel.engine,
            tmodel.full_model_arrays(), carry(cfg))


@pytest.mark.parametrize("shape", [(2, 1), (4, 2), (1, 2)])
def test_sharded_predict_matches_jax(state, shape):
    eng, ma, cfg, teng, tma, tcfg = state
    vs = np.linspace(0.5, 1.5, cfg.npad)
    eng.mesh = jax_make_mesh(*shape)
    teng.mesh = port_mesh(shape)
    try:
        want = eng.predict(cfg, ma, vs)
        got = teng.predict(tcfg, tma, vs)
    finally:
        eng.mesh = teng.mesh = None
    n = int(np.asarray(cfg.atom_mask).sum())
    for name, g, w in zip(("e", "f", "virial", "cov"), got, want):
        g, w = g.numpy(), np.asarray(w)
        close(g[:n] if name == "cov" else g, w[:n] if name == "cov" else w,
              what=name)
    # beta = sqrt(1 - c) sqrt(vscale) with c the sum of squares of choli @
    # k, whose entries reach 1e4 here (a 1e-8 ridge): it is held relative
    # to its bound sqrt(vscale), not to its values near 1e-3
    b, bw = got[4].numpy()[:n], np.asarray(want[4])[:n]
    assert np.abs(b - bw).max() <= REL * np.sqrt(vs.max())
    # and the port's own unsharded predict
    e0, f0, *_ = teng.predict(tcfg, tma, vs)
    close(got[0], e0.numpy(), what="e vs unsharded")
    close(got[1], f0.numpy(), what="f vs unsharded")


@pytest.mark.parametrize("method", ["vjp", "jac"])
def test_sharded_kernel_block_matches_jax(method):
    eng, model, _ = build_state()
    tmodel = sgpr_model_from_jax(model, **F64)
    teng = tmodel.engine
    cfg = eng.make_config(box())
    ma, tma = model.full_model_arrays(), tmodel.full_model_arrays()
    eng.mesh = jax_make_mesh(4, 2)
    teng.mesh = port_mesh((4, 2))
    want = eng.kernel_block(cfg, ma, method=method)
    got = teng.kernel_block(carry(cfg), tma, method=method)
    for name, g, w in zip(("ke", "kf", "kv"), got, want):
        close(g, w, what=name)


def _md_inputs(shape, thermostat, rebuild):
    """The same mesh-padded chunk inputs for both packages: a hot NVE or
    NHC start (dt 0.5 fs) whose 0.05 A half-skin is breached within ten
    steps when the in-loop rebuild is on (rc + skin = 3.3 A; the 7.2 A box
    admits the device rebuild)."""
    eng, model, _ = build_state()
    tmodel = sgpr_model_from_jax(model, **F64)
    cfg = eng.make_config(box())
    ma = model.full_model_arrays()
    npad, n = cfg.npad, 32
    rng = np.random.default_rng(0)
    vel = np.zeros((npad, 3))
    vel[:n] = rng.normal(0, 0.03, (n, 3))
    masses = np.ones((npad, 1))
    masses[:n, 0] = 63.5
    vs = np.ones(npad)
    skin_half = 0.05 if rebuild else 10.0
    common = dict(dt=0.5, kT=0.01, fric=0.0, skin=skin_half, bthr=1e9,
                  nsteps=10)
    nhc = None
    if thermostat == "nhc":
        nhc = (np.array([3.0, 1.0, 1.0]), 3.0 * n, np.zeros(3), np.zeros(3))
    jmesh, tmesh = jax_make_mesh(*shape), port_mesh(shape)
    return eng, tmodel, cfg, ma, vel, masses, vs, common, nhc, jmesh, tmesh


@pytest.mark.parametrize("shape,thermostat,rebuild", [
    ((3, 2), "none", False),
    ((3, 2), "none", True),
    ((2, 3), "nhc", False),
    ((2, 3), "nhc", True),
])
def test_sharded_md_chunk_matches_jax(shape, thermostat, rebuild):
    (eng, tmodel, cfg, ma, vel, masses, vs, c, nhc, jmesh,
     tmesh) = _md_inputs(shape, thermostat, rebuild)
    # JAX: mesh_pad, then the sharded chunk
    cfg2, ma2, oidx, vs2 = jax_mesh_pad(cfg, ma, vs, jmesh)
    n2 = cfg2.positions.shape[0]

    def padj(a, fill=0.0):
        out = np.full((n2,) + a.shape[1:], fill)
        out[:len(a)] = a
        return jnp.asarray(out)

    amask = jnp.asarray(np.asarray(cfg2.atom_mask)[:, None].astype(float))
    kw = dict(params=eng.params, exponent=eng.exponent, check_beta=True,
              thermostat=thermostat)
    if nhc is not None:
        kw.update(nhc_Q=jnp.asarray(nhc[0]), nhc_dof=jnp.asarray(nhc[1]),
                  nhc_vxi=jnp.asarray(nhc[2]), nhc_xi=jnp.asarray(nhc[3]))
    if rebuild:
        kw.update(rebuild=True, rebuild_cut=jnp.asarray(3.3),
                  sidx_atom=jnp.zeros(n2, jnp.int32),
                  sidx_ok=jnp.ones(n2, bool))
    import jax

    want = jax_sharded_md(
        cfg2, ma2, eng.radii_table(), eng.znum_table(), vs2, amask,
        padj(vel), padj(masses, 1.0), cfg2.positions, jax.random.PRNGKey(0),
        jnp.asarray(c["dt"]), jnp.asarray(c["kT"]), jnp.asarray(c["fric"]),
        jnp.asarray(c["skin"]), jnp.asarray(c["bthr"]),
        jnp.asarray(c["nsteps"], np.int32), oidx, mesh=jmesh, **kw)
    # the port: the chain padded to the mesh (pad_chain), then md_chunk
    # over the mesh
    teng = tmodel.engine
    tcfg = carry(cfg)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    ch = pm.pad_chain(dict(
        cfg=tcfg, ma=tmodel.full_model_arrays(), vs=t(vs), vel=t(vel),
        masses=t(masses), pos0=tcfg.positions, mean_e=None,
        sidx_atom=t(np.zeros(cfg.npad), torch.int32),
        sidx_ok=t(np.ones(cfg.npad), torch.bool)), tmesh)
    assert ch["cfg"].npad == n2
    tkw = dict(params=teng.params, exponent=teng.exponent, check_beta=True,
               thermostat=thermostat)
    if nhc is not None:
        tkw.update(nhc_Q=torch.as_tensor(nhc[0]), nhc_dof=nhc[1],
                   nhc_vxi=torch.zeros(3, dtype=torch.float64),
                   nhc_xi=torch.zeros(3, dtype=torch.float64))
    if rebuild:
        tkw.update(rebuild=True, rebuild_cut=3.3, sidx_atom=ch["sidx_atom"],
                   sidx_ok=ch["sidx_ok"])
    tcfg2 = ch["cfg"]
    got = md_chunk(
        tcfg2, ch["ma"], teng.radii_table(), ch["vs"], ch["vel"],
        ch["masses"], ch["pos0"], c["dt"], c["kT"], c["fric"], c["skin"],
        c["bthr"], c["nsteps"], mesh=tmesh, own_idx=ch["oidx"], **tkw)
    assert int(got[5]) == int(want[6]) == c["nsteps"]
    pairs = [("pos", got[0], want[0]), ("vel", got[1], want[1]),
             ("forces", got[2], want[3]), ("energy", got[3], want[4]),
             ("beta_max", got[4], want[5])]
    if nhc is not None:
        pairs += [("nhc_vxi", got[-2], want[7]), ("nhc_xi", got[-1], want[8])]
    for name, g, w in pairs:
        close(g, w, what=name)
    if rebuild:  # the tables were rebuilt: the run breached its skin
        p0 = got[7]
        assert not torch.equal(p0, tcfg2.positions)


def test_device_neb_with_mesh_matches_jax(tmp_path, monkeypatch):
    """DeviceNEB with ``engine.mesh`` in both packages (the sharded band
    loop: JAX's sharded_neb_chunk, the port's neb_chunk(mesh=...)), across
    chunk boundaries."""
    monkeypatch.chdir(tmp_path)
    eng, model, _ = build_state()
    tmodel = sgpr_model_from_jax(model, **F64)
    eng.mesh = jax_make_mesh(4, 2)
    jcalc = JaxCalc(covariance=model, calculator=None, logfile=None,
                    pckl=None, tape=None, skin=0.3)
    tcalc = ActiveCalculator(covariance=tmodel, calculator=None,
                             logfile=None, pckl=None, tape=None, skin=0.3,
                             mesh=port_mesh((4, 2)), **F64)
    bands = []
    for fcc, interp, calc in ((jax_bulk_fcc, jax_interpolate, jcalc),
                              (bulk_fcc, interpolate_images, tcalc)):
        first = box(fcc)
        last = first.copy()
        last.rattle(0.05, seed=21)
        images = interp(first, last, 5)
        for im in images:
            im.calc = calc
        bands.append(images)
    runs = []
    for Neb, images, calc in ((JaxDeviceNEB, bands[0], jcalc),
                              (DeviceNEB, bands[1], tcalc)):
        dopt = Neb(images, calc, k=0.1, dt=0.05, chunk=4, check_beta=False)
        conv = dopt.run(fmax=0.05, steps=12)
        runs.append((np.stack([im.positions for im in images]), dopt.nsteps,
                     conv))
    assert runs[0][1] == runs[1][1] == 12 and runs[0][2] == runs[1][2]
    close(runs[1][0], runs[0][0], rel=1e-12, what="band positions")
    assert np.abs(runs[1][0][2] - bands[1][0].positions).max() > 1e-4


def test_active_calculator_with_mesh_matches_jax(tmp_path, monkeypatch):
    """``ActiveCalculator(mesh=...)`` learning from an empty model takes the
    JAX package's sampling decisions under its mesh (noise optimizer off,
    single-thread sums: the decisions are threshold tests)."""
    monkeypatch.chdir(tmp_path)
    kw = dict(covariance=None, logfile=None, pckl=None, tape=None,
              kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2), ediff=0.02,
              ediff_tot=0.05, fdiff=0.08, seed=0, ioptim=10**6)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jcalc = JaxCalc(mesh=jax_make_mesh(4, 2),
                        calculator=JaxLJ(epsilon=0.15, sigma=2.3, rc=4.0),
                        **kw)
        tcalc = ActiveCalculator(mesh=port_mesh((4, 2)),
                                 calculator=LennardJones(epsilon=0.15,
                                                         sigma=2.3, rc=4.0),
                                 **kw, **F64)
        out = []
        for calc, fcc in ((jcalc, jax_bulk_fcc), (tcalc, bulk_fcc)):
            s = fcc("Cu", 3.6).repeat((2, 2, 1))
            s.rattle(0.06, seed=11)
            r1 = calc.calculate(s.copy())
            s.rattle(0.03, seed=12)
            r2 = calc.calculate(s)
            out.append((calc.size, r1, r2))
    finally:
        torch.set_num_threads(threads)
    assert out[1][0] == out[0][0] and out[1][0][1] > 0
    for k in (1, 2):
        close(out[1][k]["energy"], out[0][k]["energy"], rel=1e-8, what="e")
        close(out[1][k]["forces"], out[0][k]["forces"], rel=1e-8, what="f")


# ------------------------------------------------------------ the port alone


def test_make_mesh_aliases_and_refusals():
    m = make_mesh(data=4, model=2, devices=CPU8)
    assert isinstance(m, Mesh) and m.devices.shape == (4, 2)
    assert m.shape == {"data": 4, "model": 2}
    assert make_mesh(data=8, devices=CPU8).devices.shape == (8, 1)
    assert make_mesh(n_model=2, devices=CPU8).devices.shape == (4, 2)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():  # the default is the cards, never the CPU
        with pytest.raises(ValueError, match="have 0"):
            make_mesh(data=2)
    with pytest.raises(TypeError):
        Engine(mesh=object(), **F64)
    with pytest.raises(ValueError, match="first device"):
        Engine(mesh=make_mesh(2, devices=["meta"] * 2), **F64)


def _old_total_cov(posd, celld, cfg, X_desc, X_num, X_lone, radii, params,
                   exponent):
    """The dot-kernel body of ``_total_cov`` before the mesh (one
    function: descriptors, Gram, alpha)."""
    from autoforce_tpu_torch.engine import _config_descriptors, _self_alpha
    from autoforce_tpu_torch.engine import PLAIN

    p, lone = _config_descriptors(posd, celld, cfg, radii, params,
                                  use_rev=True)
    cov = gram(p, cfg.numbers, lone, X_desc, X_num, X_lone, exponent)
    return cov, lone, _self_alpha(p, lone, exponent, PLAIN)


def test_unsharded_path_is_unchanged_bit_for_bit():
    """Without ``oidx`` the restored argument changes nothing: the split
    ``_total_cov`` and ``kernel_block_fn`` give exactly the values of
    their earlier one-piece bodies."""
    eng, model, _ = build_state()
    tmodel = sgpr_model_from_jax(model, **F64)
    teng = tmodel.engine
    s = box(bulk_fcc)
    cfg = teng.make_config(s)
    ma = tmodel.full_model_arrays()
    radii = teng.radii_table()
    args = (cfg.positions, cfg.cell, cfg, ma.X_desc, ma.X_num, ma.X_lone,
            radii, teng.params, teng.exponent)
    new = _total_cov(*args, use_rev=True)
    old = _old_total_cov(*args)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    ke, kf, kv = kernel_block_fn(cfg, ma, radii, teng.params, teng.exponent,
                                 batch_size=2)
    rows = _stack_rows([cfg], radii, teng.params)
    m = int(ma.m_mask.sum())
    for lo in range(0, m, 2):
        sl = slice(lo, min(lo + 2, m))
        e, f, v = _columns(rows, [cfg], ma.X_desc[sl], ma.X_num[sl],
                           ma.X_lone[sl], radii, teng.params, teng.exponent)
        assert torch.equal(ke[sl], e[:, 0])
        assert torch.equal(kf[..., sl], f[:, 0].permute(1, 2, 0))
        assert torch.equal(kv[..., sl], v[:, 0].permute(1, 2, 0))


def test_sharded_step_launches_each_kernel_once_per_data_shard(monkeypatch):
    """One sharded force evaluation calls the forward and the backward
    coefficient functions once per data shard, whatever the model axis;
    a committee of two experts too."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = sk.soap_coeff_fwd, sk.soap_coeff_bwd

    def cfwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def cbwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(sk, "soap_coeff_fwd", cfwd)
    monkeypatch.setattr(sk, "soap_coeff_bwd", cbwd)
    eng, model, _ = build_state()
    tmodel = sgpr_model_from_jax(model, **F64)
    teng = tmodel.engine
    cfg = teng.make_config(box(bulk_fcc))
    ma = tmodel.full_model_arrays()
    for shape in ((2, 2), (4, 2), (1, 4)):
        mesh = port_mesh(shape)
        cfg2, ma2, oidx, vs2 = pm.mesh_pad(
            cfg, ma, torch.ones(cfg.npad, dtype=torch.float64), mesh)
        for committee in (False, True):
            m2, vs, mean_e = ma2, vs2, None
            if committee:
                m2 = type(ma2)(*(None if x is None else torch.stack([x, x])
                                 for x in ma2))
                vs, mean_e = torch.stack([vs2, vs2]), torch.zeros(
                    2, dtype=torch.float64)
            fn = pm.mesh_chunk(cfg2, m2, teng.radii_table(), vs, oidx, mesh,
                               teng.params, teng.exponent, True,
                               mean_e=mean_e).forces_fn
            calls.update(fwd=0, bwd=0)
            e, f, b = fn(cfg2.positions)
            assert calls == {"fwd": shape[0], "bwd": shape[0]}, (shape, calls)
            assert torch.isfinite(f).all() and e.dim() == 0
